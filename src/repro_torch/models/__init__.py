"""Models of the port (attention-only dense decoders in this slice)."""

from repro_torch.models.model import Model

__all__ = ["Model"]
