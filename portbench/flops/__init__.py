"""Operation and byte counts from shapes: one file for each model family
(the model FLOPs of a forward, ``mfu``'s numerator) and each kernel family
(a roofline's bound), with the card's published peaks (``peaks.py``).
Counts are of the mathematics the inputs need (no recompute, masked keys
left out), not of what a kernel happens to do."""
