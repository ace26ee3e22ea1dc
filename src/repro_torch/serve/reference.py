"""Static one-shot greedy reference decoder for token-parity checks.

Counterpart of ``repro.serve.reference``.  Decodes each request on its own —
batch=1, exact-length prefill (no bucket padding), scalar-position decode
loop — through the same ``lm.prefill`` / ``lm.decode_step`` model code the
engine runs, but via a different batching path: no slot reuse, no padding,
no per-slot position vectors, no idle-row masking.  As in JAX, the cache is
built in the compute dtype here, while the engine's cache is bf16.  A
request's frames or image embeddings go into its prefill as in the engine;
decode positions then start after the image rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed.steps import make_prefill_step, make_serve_step
from ..models import lm
from ..models.config import ModelConfig
from .engine import prefill_inputs

__all__ = ["greedy_decode", "greedy_reference"]


def greedy_decode(params, cfg: ModelConfig, req, cache_len: int, *,
                  device="cuda", expect=None):
    """Greedy tokens of one request and the fp32 logits (T, V, on the
    host) each token was taken from.  The cast to the compute dtype is a
    no-op for params that are already cast.  With ``expect`` (another
    path's tokens) the decode stops after the first token that differs
    from it: a parity check reads no further."""
    params = lm.cast_params(params, cfg)
    prefill = make_prefill_step(cfg, cache_len)
    serve = make_serve_step(cfg)
    tokens = np.asarray(req.prompt, np.int32)[None]
    logits, cache = prefill(params, prefill_inputs(cfg, req, tokens, device))
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    steps = [logits[0]]
    pos0 = cfg.n_image_tokens + req.prompt_len
    for i in range(req.max_new_tokens - 1):
        if expect is not None and int(tok[0, 0]) != expect[i]:
            break
        tok, logits, cache = serve(params, cache, tok, pos0 + i)
        steps.append(logits[0])
    all_logits = torch.stack(steps).cpu()
    return all_logits.argmax(-1).tolist(), all_logits


def greedy_reference(params, cfg: ModelConfig, requests, cache_len: int, *,
                     device="cuda") -> dict[int, list[int]]:
    """Greedy tokens for each request, rid -> tokens, batch=1 static decode.

    ``cache_len`` should match the engine's so both paths attend over the
    same cache geometry (the same rolling-window ring for the RG-LRU
    hybrid).
    """
    params = lm.cast_params(params, cfg)
    return {req.rid: greedy_decode(params, cfg, req, cache_len,
                                   device=device)[0]
            for req in requests}
