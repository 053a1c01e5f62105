"""Loss and metric ops of the training steps (counterpart of the JAX
ops/losses.py): `label_smoothing_ce` and `masked_accuracy` (stage 1);
`kl_to_reference`, `chunked_ce_kl` and `masked_log_likelihood` (stage 2 and
the scorer).

Inside a data-parallel train step (parallel/mesh.py `data_parallel`) the
training means (`label_smoothing_ce`, `masked_accuracy`, `chunked_ce_kl`)
divide the rank's own sum by the global batch's count, so the ranks'
values add up to the global mean.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from taste_spokenlm_tpu_torch.parallel import mesh

IGNORE_ID = -1


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.0, normalize_length: bool = True,
                       ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) summed over the valid
    positions, over the token count (normalize_length) or the batch size.
    logits [B, T, V]; targets [B, T] with `ignore_id` masked.  The closed
    form of JAX: the constant entropy of the smoothed one-hot, minus
    (conf - low) log q_target and low * sum log q, on an f32 log-softmax."""
    v = logits.shape[-1]
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1) if v > 1 else 0.0
    entropy = 0.0
    if low > 0.0:
        entropy += (v - 1) * low * math.log(low)
    if confidence > 0.0:
        entropy += confidence * math.log(confidence)
    logp_tgt = torch.gather(logp, -1, tgt[..., None])[..., 0]
    cross = (confidence - low) * logp_tgt
    if low > 0.0:
        cross = cross + low * logp.sum(dim=-1)
    kl = torch.where(valid, entropy - cross, torch.zeros_like(cross))
    denom = (torch.clamp(mesh.global_sum(valid.sum()), min=1)
             if normalize_length else logits.shape[0] * mesh.span())
    return kl.sum() / denom


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Top-1 accuracy over the non-ignored targets."""
    valid = targets != ignore_id
    correct = ((logits.argmax(dim=-1) == targets) & valid).sum()
    return correct.float() / torch.clamp(mesh.global_sum(valid.sum()),
                                         min=1).float()


def masked_log_likelihood(logits: torch.Tensor, targets: torch.Tensor,
                          ignore_id: int = IGNORE_ID, head_size: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean log-likelihood of the valid targets, the same of the valid
    targets reversed in time on the same logits): the reference scorer's
    selection protocol and its control.  logits [..., T, V], targets
    [..., T] (leading dims flattened); `head_size` > 0 also masks the
    labels >= it."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(-1, v)
    labels = targets.reshape(-1).long()
    valid = labels != ignore_id
    if head_size > 0:
        valid = valid & (labels < head_size)
    n = valid.sum()
    t = labels.shape[0]
    # the valid labels compacted to the front by their rank, read back
    # reversed: valid position j pairs with compact[n - 1 - j]
    pos = torch.cumsum(valid.long(), dim=0) - 1
    slot = torch.where(valid, pos, torch.full_like(pos, t))
    compact = torch.zeros(t + 1, dtype=labels.dtype, device=labels.device)
    compact = compact.scatter(0, slot, labels)[:t]
    rev = compact[torch.clamp(n - 1 - pos, 0, t - 1)]

    def at(lab):
        return torch.gather(logp, 1, lab.clamp(0, v - 1)[:, None])[:, 0]
    denom = torch.clamp(n, min=1)
    zero = torch.zeros((), device=logp.device)
    return (torch.where(valid, at(labels), zero).sum() / denom,
            torch.where(valid, at(rev), zero).sum() / denom)


def kl_to_reference(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean KL(teacher || student) over the valid positions (the teacher
    detached): the KL-to-frozen-base term of the stage-2 text loss."""
    tprob = torch.softmax(teacher_logits.detach().float(), dim=-1)
    logq = torch.log_softmax(student_logits.float(), dim=-1)
    logt = torch.log(torch.clamp(tprob, min=1e-20))
    kl = (tprob * (logt - logq)).sum(dim=-1)
    if mask is None:
        return kl.mean()
    kl = torch.where(mask, kl, torch.zeros_like(kl))
    return kl.sum() / torch.clamp(mask.sum(), min=1)


def chunked_ce_kl(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                  hidden: torch.Tensor, labels: torch.Tensor,
                  ref_hidden: Optional[torch.Tensor] = None,
                  ref_logits: Optional[torch.Tensor] = None,
                  chunk_size: int = 64):
    """Cross-entropy (and, with a teacher, KL(teacher || student)) over the
    labels != IGNORE_ID without the full [B, T, V] logits: the head and the
    softmax run a time chunk at a time, each chunk checkpointed, so the
    backward recomputes its [B, chunk, V] block.  T is padded to a
    multiple of `chunk_size` with IGNORE_ID labels.

    The teacher is the frozen base's hidden state `ref_hidden` [B, T, H]
    (projected through the same head per chunk) or precomputed
    `ref_logits` [B, Tr, V], never both; it runs under no_grad, and with
    `ref_logits` the KL counts only the positions below Tr.  -> (text_ce,
    kl), kl None without a teacher; both masked means."""
    if ref_hidden is not None and ref_logits is not None:
        raise ValueError("chunked_ce_kl takes ref_hidden or ref_logits, "
                         "not both")
    b, t, _ = hidden.shape
    pad = (-t) % chunk_size
    total = t + pad
    hidden = F.pad(hidden, (0, 0, 0, pad))
    labels = F.pad(labels.long(), (0, pad), value=IGNORE_ID)
    valid = labels != IGNORE_ID
    kl_valid = valid
    ref = None
    if ref_hidden is not None:
        ref = F.pad(ref_hidden.detach(), (0, 0, 0, pad))
    elif ref_logits is not None:
        tr = ref_logits.shape[1]
        kl_valid = valid & (torch.arange(total, device=labels.device)[None]
                            < tr)
        # padded in the teacher's dtype: the f32 cast is per chunk
        ref = F.pad(ref_logits.detach(), (0, 0, 0, total - tr))

    def one(h_c, l_c, r_c, kv_c):
        logp = torch.log_softmax(logits_fn(h_c).float(), dim=-1)
        nll = -torch.gather(logp, -1, l_c.clamp(min=0)[..., None])[..., 0]
        nll_sum = torch.where(l_c != IGNORE_ID, nll,
                              torch.zeros_like(nll)).sum()
        if r_c is None:
            return nll_sum, torch.zeros_like(nll_sum)
        with torch.no_grad():
            tlogits = logits_fn(r_c) if ref_hidden is not None else r_c
            tprob = torch.softmax(tlogits.float(), dim=-1)
            logt = torch.log(torch.clamp(tprob, min=1e-20))
        kl = (tprob * (logt - logp)).sum(dim=-1)
        return nll_sum, torch.where(kv_c, kl, torch.zeros_like(kl)).sum()

    nll_sums, kl_sums = [], []
    for i in range(0, total, chunk_size):
        sl = slice(i, i + chunk_size)
        args = (hidden[:, sl], labels[:, sl],
                None if ref is None else ref[:, sl], kl_valid[:, sl])
        if torch.is_grad_enabled():
            nll_sum, kl_sum = checkpoint(one, *args, use_reentrant=False)
        else:
            nll_sum, kl_sum = one(*args)
        nll_sums.append(nll_sum)
        kl_sums.append(kl_sum)
    text_ce = (torch.stack(nll_sums).sum()
               / torch.clamp(mesh.global_sum(valid.sum()), min=1))
    if ref is None:
        return text_ce, None
    return text_ce, (torch.stack(kl_sums).sum()
                     / torch.clamp(mesh.global_sum(kl_valid.sum()), min=1))
