"""Serving: batch inference (``model.py``), the exported artifacts
(``export.py``) and their streaming runner (``streaming.py``). Importing
the package loads no model, training or streaming module; the exporters
import them when called."""

from .export import (
    ExportedModel,
    export_beam,
    export_inference,
    export_streaming,
    export_streaming_conformer_params,
    export_streaming_params,
    load_exported,
)
from .streaming import ExportedStreamer, load_exported_streamer

__all__ = [
    "ExportedModel",
    "export_beam",
    "ExportedStreamer",
    "export_inference",
    "export_streaming",
    "export_streaming_conformer_params",
    "export_streaming_params",
    "load_exported",
    "load_exported_streamer",
]
