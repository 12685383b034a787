"""Model payloads: the paper's MNIST CNN (``cnn``) and the LMs for serving
and training through ``api.Model``: ``lm`` (GQA or MLA attention, dense or
mixture-of-experts MLPs, the vision stub, RWKV6), ``hybrid`` (Mamba2
layers with a shared attention block) and ``encdec`` (Whisper's
encoder-decoder over stub audio frames)."""

from repro_torch.models.api import VLM_PATCH_TOKENS, Model

__all__ = ["Model", "VLM_PATCH_TOKENS"]
