"""Sequential one-request-at-a-time greedy decode, the exactness oracle
(port of ``serving/reference.py``).

The semantics the continuous-batching engine must reproduce: each prompt
gets a fresh dense cache of the same view length, an exact-length prefill,
then single-token greedy decode until EOS or the budget runs out.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.launch.steps import make_decode_step


def sequential_decode(
    model: Any,
    params: Any,
    prompts: list[list[int]],
    *,
    max_new: int = 16,
    view_len: int = 128,
    eos_id: Optional[int] = None,
) -> list[list[int]]:
    """Greedy-decode each prompt independently; returns generated ids
    (EOS included when hit, like the engine's completions)."""
    decode = make_decode_step(model)
    out: list[list[int]] = []
    for prompt in prompts:
        state = model.init_state(1, view_len)
        toks = torch.tensor([prompt], dtype=torch.long, device=model.device)
        logits, state = model.prefill(params, {"tokens": toks}, state)
        tok = logits[:, -1:].argmax(dim=-1)
        gen = [int(tok[0, 0])]
        while len(gen) < max_new and (eos_id is None or gen[-1] != eos_id):
            tok, _, state = decode(params, tok, state)
            gen.append(int(tok[0, 0]))
        out.append(gen)
    return out
