"""Plain PyTorch references of the benchmark's model families.

Float32, no kernels, no cache, no batching tricks: each family's forward
(train and eval), its loss and, through autograd, its gradients, written
from the published recipes. Nothing here imports the port
(``neural_speech_decoder_tpu_torch``) or the JAX package; the randomness of
a train step (noise, dropout, DropPath, SpecAugment) is drawn from a
``torch.Generator`` seeded as the benchmark seeds the program's, in the
order the recipe draws it, and the counter-based dropout hash is a frozen
copy (``hashrng.py``).
"""
