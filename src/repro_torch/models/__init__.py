"""Model payloads: the paper's MNIST CNN (``cnn``) and the dense GQA
decoder LM for serving (``lm`` through ``api.Model``). The other LM
families of ``repro.models`` are not ported yet."""

from repro_torch.models.api import Model

__all__ = ["Model"]
