"""Constrained beam search with an n-best list.

Port of ``molnextr_tpu/decoding/beam.py::beam_decode`` as a host loop over
device steps, in the manner of ``greedy_decode``:

* the memory is repeated to ``B*K`` rows and only beam 0 is live at step 0
  (``logprob_sum`` starts at ``[0, -1e9, ...]``), so identical expansions do
  not crowd the beam;
* the grammar constraint is a -10000 penalty, EOS is -1e9 before
  ``min_len`` tokens, and a finished lane emits PAD at log-prob 0 with
  every other token at -1e9;
* the top ``K`` of the ``(B, K*V)`` candidates are taken in
  ``jax.lax.top_k``'s order (:func:`select_top_k`), and every piece of
  beam-carried state, the decode cache included, is reordered by the
  source beam of each winner;
* the score is the length-normalised log-probability; the best beam is its
  argmax and the n-best list is sorted by it, stably.

Early exit is checked every ``unroll`` steps; that check is the loop's only
host sync.  A step taken after every beam has finished leaves the state as
it was (the JAX loop would not have run it), so the check's granularity
never changes the outputs.  The self cache is one ``T``-long buffer instead
of the JAX decode's phased growth (see ``models/decoder.py``); the decode
step writes position ``pos`` in place, and the reorder runs after the step,
so the gathered rows include it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from molnextr_tpu_torch.tokenization import EOS_ID, PAD_ID, SOS_ID

NEG_INF = -1e9


def select_top_k(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``flat`` (values, indices),
    in descending order and, among equal values, the lower index first:
    the order of ``jax.lax.top_k``, which ``torch.topk`` does not promise."""
    values, indices = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def reorder_cache(cache: Dict[str, torch.Tensor], flat_idx: torch.Tensor,
                  batch_axis: int = 1) -> Dict[str, torch.Tensor]:
    """Gather every cache leaf's ``B*K`` rows (on ``batch_axis``) by
    ``flat_idx``, the source row of each new beam."""
    return {key: x.index_select(batch_axis, flat_idx) for key, x in cache.items()}


def beam_decode(
    step_fn,
    init_cache_fn,
    memory: torch.Tensor,
    token_class: torch.Tensor,
    class_mask: torch.Tensor,
    max_len: int,
    hidden_size: int,
    beam_size: int = 5,
    min_len: int = 1,
    use_constraint: bool = True,
    cache_batch_axis: int = 1,
    return_all: bool = False,
    unroll: int = 1,
):
    """step_fn(tokens (N,), pos, cache) -> (logits (N, V), hidden (N, D),
    cache); init_cache_fn(memory) -> cache, whose leaves hold the ``N = B*K``
    rows on ``cache_batch_axis``.

    Returns the best hypothesis per image, (seq (B, L), avg_scores (B,),
    token_scores (B, L), hiddens (B, L, D)), as ``greedy_decode`` does, so
    the edge head can read the best beam's hidden states; with
    ``return_all`` also (all_seq (B, K, L), all_scores (B, K)), every
    hypothesis sorted by its normalised score.
    """
    b, k = memory.shape[0], beam_size
    dev = memory.device
    cache = init_cache_fn(memory.repeat_interleave(k, dim=0))

    tokens = torch.full((b * k,), SOS_ID, dtype=torch.long, device=dev)
    seq = torch.full((b, k, max_len), PAD_ID, dtype=torch.long, device=dev)
    logprob_sum = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    logprob_sum[:, 0] = 0.0
    token_scores = torch.zeros((b, k, max_len), dtype=torch.float32, device=dev)
    hiddens = torch.zeros((b, k, max_len, hidden_size), dtype=memory.dtype, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.long, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    same_beam = torch.arange(k, device=dev).expand(b, k)
    first_row = torch.arange(b, device=dev)[:, None] * k

    for step in range(max_len):
        if step and step % unroll == 0 and bool(finished.all()):
            break
        live = ~finished.all()
        logits, hidden, cache = step_fn(tokens, step, cache)
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        if use_constraint:
            logp = torch.where(class_mask[token_class[tokens]], logp - 10000.0, logp)
        if step < min_len:
            logp[:, EOS_ID] = NEG_INF
        pad_row = torch.full((v,), NEG_INF, device=dev)
        pad_row[PAD_ID] = 0.0
        logp = torch.where(finished[..., None], pad_row, logp.reshape(b, k, v))

        top_val, top_idx = select_top_k((logprob_sum[..., None] + logp).reshape(b, k * v), k)
        # once every beam has finished the state stays as it is
        beam_idx = torch.where(live, top_idx // v, same_beam)
        next_tok = torch.where(live, top_idx % v, PAD_ID)
        top_val = torch.where(live, top_val, logprob_sum)
        step_score = top_val - logprob_sum.gather(1, beam_idx)

        seq = seq.gather(1, beam_idx[..., None].expand_as(seq))
        token_scores = token_scores.gather(1, beam_idx[..., None].expand_as(token_scores))
        hiddens = hiddens.gather(1, beam_idx[..., None, None].expand_as(hiddens))
        lengths = lengths.gather(1, beam_idx)
        finished = finished.gather(1, beam_idx)
        flat_idx = (first_row + beam_idx).reshape(-1)
        cache = reorder_cache(cache, flat_idx, cache_batch_axis)
        hidden = hidden.index_select(0, flat_idx).reshape(b, k, -1)

        seq[:, :, step] = next_tok
        token_scores[:, :, step] = torch.where(finished, 0.0, step_score)
        hiddens[:, :, step] = torch.where(live, hidden.to(hiddens.dtype), hiddens[:, :, step])
        lengths = lengths + (~finished).long()
        finished = finished | (next_tok == EOS_ID)
        logprob_sum = top_val
        tokens = next_tok.reshape(-1)

    norm = logprob_sum / lengths.clamp_min(1).float()
    best = norm.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    avg = torch.exp(norm[rows, best])
    out = (seq[rows, best], avg, token_scores[rows, best], hiddens[rows, best])
    if return_all:
        order = torch.argsort(-norm, dim=1, stable=True)
        all_seq = seq.gather(1, order[..., None].expand_as(seq))
        return out + (all_seq, torch.exp(norm.gather(1, order)))
    return out
