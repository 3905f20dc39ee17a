"""Greedy constrained decoding.

Port of ``molnextr_tpu/decoding/greedy.py::greedy_decode`` as a host loop
over device steps:

* the grammar constraint is ``class_mask[token_class[tokens]]`` applied as
  a -10000 penalty on the log-probabilities;
* EOS is set to -1e20 before ``min_len`` tokens;
* finished lanes are frozen: they emit PAD with score 0;
* the confidence is the exponential of the mean token score;
* MASK-label partial prediction and temperature/top-k sampling are kept;
  sampling draws from an explicit ``torch.Generator`` (its numbers differ
  from ``jax.random``'s, its distribution does not).

Early exit is checked every ``unroll`` steps; that check is the loop's only
host sync.  Finished lanes only ever write PAD, so the check's granularity
never changes the outputs.  The self cache is one ``T``-long buffer instead
of the JAX decode's phased growth (see ``models/decoder.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from molnextr_tpu_torch.tokenization import EOS_ID, MASK_ID, PAD_ID, SOS_ID


def greedy_decode(
    step_fn,
    init_cache_fn,
    memory: torch.Tensor,
    token_class: torch.Tensor,
    class_mask: torch.Tensor,
    max_len: int,
    hidden_size: int,
    min_len: int = 1,
    use_constraint: bool = True,
    unroll: int = 1,
    labels: Optional[torch.Tensor] = None,
    sampling_temp: float = 0.0,
    keep_topk: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """step_fn(tokens (B,), pos, cache) -> (logits (B, V), hidden (B, D), cache);
    init_cache_fn(memory) -> cache.

    Returns (seq (B, max_len), avg_scores (B,), token_log_scores
    (B, max_len), hiddens (B, max_len, D)); sequences end with EOS then PAD.
    ``labels`` (B, L) starting with SOS forces every non-MASK entry and
    lets the model fill the MASK slots; PAD marks the end of a label.
    """
    b = memory.shape[0]
    dev = memory.device
    cache = init_cache_fn(memory)
    sample = sampling_temp != 0.0 and keep_topk != 1
    if sample and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if labels is not None:
        pad_w = max(0, max_len + 2 - labels.shape[1])
        labels = torch.nn.functional.pad(labels.long(), (0, pad_w), value=PAD_ID)

    tokens = torch.full((b,), SOS_ID, dtype=torch.long, device=dev)
    seq = torch.full((b, max_len), PAD_ID, dtype=torch.long, device=dev)
    log_scores = torch.zeros((b, max_len), dtype=torch.float32, device=dev)
    hiddens = torch.zeros((b, max_len, hidden_size), dtype=memory.dtype, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)

    for step in range(max_len):
        if step and step % unroll == 0 and bool(finished.all()):
            break
        logits, hidden, cache = step_fn(tokens, step, cache)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if use_constraint:
            mask = class_mask[token_class[tokens]]
            logp = torch.where(mask, logp - 10000.0, logp)
        if step < min_len:
            logp[:, EOS_ID] = -1e20
        if sample:
            scaled = logp / sampling_temp
            if keep_topk > 0:
                kth = torch.topk(scaled, keep_topk, dim=-1).values[:, -1:]
                scaled = torch.where(scaled < kth, torch.full_like(scaled, -10000.0), scaled)
            probs = torch.softmax(scaled, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            score = torch.gather(scaled, 1, nxt[:, None])[:, 0]
        else:
            nxt = torch.argmax(logp, dim=-1)
            score = torch.gather(logp, 1, nxt[:, None])[:, 0]
        newly_finished = nxt == EOS_ID
        if labels is not None:
            lab = labels[:, step + 1]
            has = lab != PAD_ID
            nxt = torch.where(has & (lab != MASK_ID), lab, nxt)
            newly_finished = torch.where(has, lab == EOS_ID, nxt == EOS_ID)
        nxt = torch.where(finished, torch.full_like(nxt, PAD_ID), nxt)
        score = torch.where(finished, torch.zeros_like(score), score)
        seq[:, step] = nxt
        log_scores[:, step] = score
        hiddens[:, step] = hidden.to(hiddens.dtype)
        finished = finished | newly_finished
        tokens = nxt

    gen_mask = seq != PAD_ID
    counts = gen_mask.sum(dim=1).clamp_min(1)
    avg = torch.exp((log_scores * gen_mask).sum(dim=1) / counts)
    return seq, avg, log_scores, hiddens
