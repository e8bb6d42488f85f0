"""InternVL2-style VLM: the InternLM2 dense backbone behind a stubbed ViT
frontend — the port of the JAX package's ``models/vlm.py``.

The modality frontend is a stub, as there: the caller passes the patch
embeddings ``image_embeds [B, n_img_tokens, d_model]`` that InternViT and
the MLP projector would emit.  They are prepended to the token embeddings
and the backbone runs over ``[image; text]`` at positions ``arange(n_img +
S)``; the forward returns the text positions' logits, so ``loss`` (the
dense family's) is taken over the text.

``prefill(tokens, cache, image_embeds)`` runs the padded cache's layer
loop (``DenseLM._run_embeds_with_cache``) over ``[image; prompt]``: the
cache holds the image rows too, and ``decode_step`` goes on from there.
``decode_step`` and the slot-paged serving path are the dense family's,
text only, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from .base import InputSpec, register_family
from .transformer import DenseLM


def _prepend(img, h_txt):
    """``[img; h_txt]`` along the sequence — module-level so a region
    captures it as one node."""
    return torch.cat([img.to(h_txt.dtype), h_txt], dim=1)


@register_family("vlm")
class InternVLM(DenseLM):
    """The dense LM with an image prefix (``DenseLM``'s weights, init and
    serving)."""

    FAMILY = "vlm"

    def _with_image(self, embed, tokens, image_embeds):
        cdt = to_torch_dtype(self.cfg.compute_dtype)
        return tapir.lift(_prepend, image_embeds.to(cdt),
                          self._embed(embed, tokens))

    def forward(self, batch: dict, params: Optional[dict] = None):
        """Logits ``[B, S, vocab]`` of the text ``batch["tokens"] [B, S]``
        after the image prefix ``batch["image_embeds"] [B, n_img, d]``,
        every weight read from ``params`` (default: ``param_tree()``)."""
        if params is None:
            params = self.param_tree()
        img = batch["image_embeds"]
        h = self._with_image(params["embed"], batch["tokens"], img)
        h = self.backbone(h, params["blocks"])
        return self._head(h, params)[:, img.shape[1]:]

    def prefill(self, tokens, cache, image_embeds=None):
        """Prompts ``tokens [B, S]`` after the image prefix ``image_embeds
        [B, n_img, d]`` (none: the dense family's text prefill) into an
        empty ``cache``; returns (logits ``[B, vocab]`` at the last prompt
        position, cache), ``pos`` at ``n_img + S``."""
        if image_embeds is None:
            return super().prefill(tokens, cache)
        h = self._with_image(self.embed, tokens, image_embeds)
        return self._run_embeds_with_cache(h, cache, is_prefill=True)

    def input_specs(self, seq_len: int, batch: int, kind: str) -> dict:
        """The base specs plus the stub frontend's ``image_embeds [batch,
        n_img_tokens, d_model]`` in the compute dtype for train and
        prefill."""
        cfg = self.cfg
        specs = super().input_specs(seq_len, batch, kind)
        if kind in ("train", "prefill"):
            specs["image_embeds"] = InputSpec(
                (batch, cfg.n_img_tokens, cfg.d_model),
                to_torch_dtype(cfg.compute_dtype))
        return specs
