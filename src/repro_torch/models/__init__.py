"""Model payloads: the paper's MNIST CNN (``cnn``) and the decoder LM for
serving and training (``lm`` through ``api.Model``: GQA or MLA attention,
dense or mixture-of-experts MLPs, the vision stub). RWKV, the hybrid and
the encoder-decoder families of ``repro.models`` are not ported yet."""

from repro_torch.models.api import VLM_PATCH_TOKENS, Model

__all__ = ["Model", "VLM_PATCH_TOKENS"]
