"""See the package docstring of neural_speech_decoder_tpu_torch.

Importing the package registers the serving kernels as the operators
``torch.ops.nsd_torch.*`` (``library.py``), which the wrappers' eager
entry points call."""

from . import library  # noqa: F401
