"""See the package docstring of neural_speech_decoder_tpu_torch."""
