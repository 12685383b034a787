"""Model payloads: the paper's MNIST CNN (``cnn``) and the decoder LMs for
serving and training through ``api.Model``: ``lm`` (GQA or MLA attention,
dense or mixture-of-experts MLPs, the vision stub, RWKV6) and ``hybrid``
(Mamba2 layers with a shared attention block). The encoder-decoder family
of ``repro.models`` is not ported yet."""

from repro_torch.models.api import VLM_PATCH_TOKENS, Model

__all__ = ["Model", "VLM_PATCH_TOKENS"]
