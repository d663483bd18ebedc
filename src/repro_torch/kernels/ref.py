"""Plain PyTorch versions of the port's kernels.

They define the bits the CUDA kernels in ``csrc/`` must produce.  On the
CPU the port runs them; on the card only the tests and ``chip_smoke.py``
call them, to hold each kernel against its plain version.  Every scan,
count and index stays int32, as in the JAX Task Vector: ``torch.cumsum``
and ``.sum()`` of int32 default to int64, so each call names its dtype.
"""
from __future__ import annotations

import torch

_I32 = torch.int32


def fork_scan_ref(counts: torch.Tensor):
    """Exclusive prefix sum + total of an i32 vector (plain ``fork_scan``).

    Returns ``(offsets i32[C], total i32[])``.
    """
    counts = counts.to(_I32)
    incl = torch.cumsum(counts, 0, dtype=_I32)
    total = incl[-1] if counts.shape[0] else counts.new_zeros(())
    return incl - counts, total


def segmented_fork_scan_ref(counts: torch.Tensor, seg: torch.Tensor,
                            n_segs: int):
    """Per-segment exclusive prefix sum + per-segment totals (plain
    ``segmented_fork_scan``), one masked scan per segment.

    ``seg[i]`` is lane i's segment (TV region) id; ids outside ``[0,
    n_segs)`` add nothing and read 0.  Returns ``(offsets i32[C], totals
    i32[n_segs])``.
    """
    counts = counts.to(_I32)
    seg = seg.to(_I32)
    offs = torch.zeros_like(counts)
    totals = []
    for s in range(n_segs):
        m = seg == s
        x = torch.where(m, counts, 0)
        offs = torch.where(m, torch.cumsum(x, 0, dtype=_I32) - x, offs)
        totals.append(x.sum(dtype=_I32))
    if not totals:
        return offs, counts.new_zeros((0,))
    return offs, torch.stack(totals)


def type_rank_ref(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """Stable within-type rank of each active lane + per-type counts.

    ``rank[i]`` is the number of active lanes of lane i's type before lane
    i (-1 for an inactive lane).  Returns ``(rank i32[C],
    counts i32[n_types])``.
    """
    types = types.to(_I32)
    act = active.to(torch.bool)
    ids = torch.arange(n_types, dtype=_I32, device=types.device)
    # [n_types, C]: each type's indicator row is scanned along the lanes
    onehot = ((ids[:, None] == types[None, :]) & act[None, :]).to(_I32)
    pos = torch.cumsum(onehot, 1, dtype=_I32) - onehot
    rank = pos.gather(0, types.clamp(0, n_types - 1).long()[None, :])[0]
    rank = torch.where(act, rank, -1)
    return rank, onehot.sum(1, dtype=_I32)


def rank_to_perm(rank: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Scatter a stable within-mask rank into a pack permutation.

    ``perm[d]`` is the lane position of the d-th active lane (increasing,
    so fork-allocation order is preserved), -1 beyond the active
    population.  The JAX reference drops inactive lanes with an
    out-of-range index (``mode="drop"``); torch has none, so they land in
    a sink entry ``P`` that is cut off.
    """
    P = rank.shape[0]
    perm = torch.full((P + 1,), -1, dtype=_I32, device=rank.device)
    perm[torch.where(active.to(torch.bool), rank, P)] = torch.arange(
        P, dtype=_I32, device=rank.device
    )
    return perm[:P]


def lane_pack_ref(active: torch.Tensor):
    """Stable frontier pack of the scheduled lanes (gather dispatch).

    Returns ``(perm i32[P], count i32[])`` (:func:`rank_to_perm`).
    """
    act = active.to(torch.bool)
    a = act.to(_I32)
    rank = torch.cumsum(a, 0, dtype=_I32) - a
    return rank_to_perm(rank, act), a.sum(dtype=_I32)


def type_pack_ref(types: torch.Tensor, active: torch.Tensor, n_types: int):
    """The compaction stage's permutation (plain ``type_pack``).

    Each active lane gets ``dest = type_start[type] + rank``, ``rank`` its
    stable within-type rank and ``type_start`` the exclusive prefix sum of
    the per-type populations.  Returns ``(perm i32[C], counts
    i32[n_types])``: ``perm[d]`` is the lane position of the d-th
    compacted lane, -1 beyond the active population.  Active lanes must
    carry a type in ``[0, n_types)``.
    """
    act = active.to(torch.bool)
    rank, counts = type_rank_ref(types, act, n_types)
    type_start, _ = fork_scan_ref(counts)
    return type_perm(types, act, rank, type_start), counts


def type_perm(types: torch.Tensor, active: torch.Tensor, rank: torch.Tensor,
              type_start: torch.Tensor) -> torch.Tensor:
    """Scatter each active lane to ``type_start[type] + rank``: the
    compaction permutation from per-type ranks and offsets (``perm[d]`` the
    lane position of the d-th compacted lane, -1 beyond the active
    population)."""
    P = types.shape[0]
    n_types = type_start.shape[0]
    dest = type_start[types.clamp(0, n_types - 1)] + rank
    # tvm.py drops inactive lanes at index P (mode="drop"): sink entry P here
    perm = torch.full((P + 1,), -1, dtype=_I32, device=types.device)
    perm[torch.where(active.to(torch.bool), dest, P)] = torch.arange(
        P, dtype=_I32, device=types.device
    )
    return perm[:P]


def ordered_add_ref(arr: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``ordered_add`` kernel: ``arr[idx] += val`` with
    each row's terms added one at a time in source order, starting from
    the old value — the CPU ``index_add_``'s serial loop, whose rounding
    the JAX reference's CPU scatter shares.

    A stable sort groups each row's terms in source order; the ``k``-th
    term of every row is then added by one gather/add/store over rows that
    are all distinct, ``k`` = 0, 1, ... up to the longest run (two host
    reads: the kept terms and the run lengths).  Writes to the sink row
    (the last) are skipped (nothing reads it).  Returns ``arr``.
    """
    sink = arr.shape[0] - 1
    keep = torch.nonzero(idx != sink).flatten()
    if keep.numel() == 0:
        return arr
    sidx, order = torch.sort(idx[keep], stable=True)
    sval = val[keep[order]]
    m = sidx.shape[0]
    pos = torch.arange(m, device=idx.device)
    first = torch.ones(m, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - run_start  # the term's place within its row's run
    by_rank = torch.sort(rank, stable=True).indices
    lo = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[lo:lo + c]
        rows = sidx[sel]
        arr[rows] = arr[rows] + sval[sel]
        lo += c
    return arr


def epoch_chunk_ref(cond_fn, body_fn, carry, limit):
    """Plain version of the ``epoch_chunk`` kernel (``epoch_megakernel.py``).

    One K-epoch chunk of the resident loop — pop, step, commit, push, map
    payloads — as a host loop over the carry: ``while cond_fn(carry,
    limit): carry = body_fn(carry)``.  ``cond_fn`` returns a host bool, so
    the host reads the condition once per iteration; the kernel reads it
    on the device and must produce the same bits.
    """
    while cond_fn(carry, limit):
        carry = body_fn(carry)
    return carry


# ------------------------------------------------------------- attention
def _attn_mask(Sq: int, Skv: int, causal: bool, q_offset: int, window: int,
               device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, scale: float | None = None,
            q_offset: int = 0, window: int = 0, return_lse: bool = False):
    """Grouped-query attention (plain ``mha_flash``), float32 accumulation.

    q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  Query i sits at absolute position ``q_offset + i`` for the
    causal mask; ``window > 0`` keeps the last ``window`` positions.  With
    ``return_lse`` also the float32 log-sum-exp of each row's scaled
    scores (B, Hq, Sq), what the kernel writes for its backward.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, group, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal or window > 0:
        mask = _attn_mask(Sq, Skv, causal, q_offset, window, q.device)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(B, Hq, Sq, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B, Hq, Sq)
    return out


def mha_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     causal: bool = True, scale: float | None = None,
                     q_offset: int = 0, window: int = 0):
    """The gradient of :func:`mha_ref` from its output ``o`` and
    log-sum-exp ``lse`` (plain ``flash_attention_bwd``): ``(dq, dk, dv)``
    in the inputs' dtype, computed in float32 as the backward kernels do:
    P = exp(s - lse) over the visible keys (0 elsewhere), dV = Pᵀ dO,
    δ = rowsum(dO ∘ O), dS = P ∘ (dO Vᵀ - δ), dQ = scale dS K and
    dK = scale dSᵀ Q, a GQA group's heads summed into their kv head."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    dof = do.float().reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, Hkv, g, Sq, 1))
    if causal or window > 0:
        mask = _attn_mask(Sq, Skv, causal, q_offset, window, q.device)
        p = p.masked_fill(~mask, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (do.float() * o.float()).sum(-1).reshape(B, Hkv, g, Sq, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def mha_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None,
                  q_offset: int = 0, window: int = 0,
                  block_k: int = 512) -> torch.Tensor:
    """The same function as :func:`mha_ref` as an online softmax over key
    blocks of ``block_k`` (O(Sq * block_k) score memory), masked with the
    kernels' -1e30 sentinel."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    block_k = min(block_k, Skv)
    qf = q.float().reshape(B, Hkv, g, Sq, D) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    m = torch.full((B, Hkv, g, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, D), device=q.device)
    for k0 in range(0, Skv, block_k):
        kpos = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        if kb.shape[2] < block_k:  # the reference pads the last block
            pad = block_k - kb.shape[2]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        mask = kpos < Skv
        if causal:
            mask = mask & (qpos >= kpos)
        if window > 0:
            mask = mask & (qpos - kpos < window)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         scale: float | None = None,
                         window: int = 0) -> torch.Tensor:
    """One-token GQA decode over a ragged cache (plain
    ``decode_attention``): q (B, Hq, D), caches (B, Hkv, S, D), lengths
    i32[B].  Cache row j of sequence b is read when ``j < lengths[b]`` (a
    length above S reads every row) and, with a window, when
    ``j >= lengths[b] - window``."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, group, D)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens  # (B, S)
    if window > 0:
        valid = valid & (pos >= lens - window)
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)



def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               split: int, window: int = 0,
                               scale: float | None = None) -> torch.Tensor:
    """The ``decode_attention`` kernel's split-K algorithm in plain PyTorch
    (tests only): the cache rows are cut into splits of ``split`` rows; each
    split gives a float32 partial (its max m, its sum l, its accumulator)
    over its visible rows, in log2 units, and the partials with l > 0 are
    merged as ``sum acc_s 2^(m_s - M) / sum l_s 2^(m_s - M)``.  The same
    function as :func:`decode_attention_ref`, except that a sequence with
    no visible row reads 0."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    n = max(1, -(-S // split))
    pad = n * split - S
    log2e = 1.4426950408889634
    qf = q.float().reshape(B, Hkv, group, D) * (scale * log2e)
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad))
    s = torch.einsum("bhgd,bhkd->bhgk", qf, kf)
    pos = torch.arange(n * split, device=q.device)[None]
    lens = lengths.to(q.device).long()[:, None]
    valid = pos < lens.clamp(max=S)
    if window > 0:
        valid = valid & (pos >= lens - window)
    valid = valid[:, None, None].reshape(B, 1, 1, n, split)
    s = s.reshape(B, Hkv, group, n, split).masked_fill(~valid, -1e30)
    m = s.amax(-1)                                        # (B, Hkv, g, n)
    p = torch.where(valid, torch.exp2(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgnk,bhnkd->bhgnd", p,
                       vf.reshape(B, Hkv, n, split, D))
    has = l > 0
    top = torch.where(has, m, -1e30).amax(-1, keepdim=True)
    w = torch.where(has, torch.exp2(m - top), 0.0)
    out = (acc * w[..., None]).sum(-2) \
        / torch.clamp((l * w).sum(-1), min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)

# ------------------------------------------------------------------- SSD
# Batched over a leading sequence axis: x (Bt, S, H, P), dt (Bt, S, H),
# A (H,), B and C (Bt, S, N) shared by every head, h0 (Bt, H, P, N) or None.
# Both return y (Bt, S, H, P) in x's dtype and the final state (Bt, H, P, N)
# in float32, as the reference's per-sequence versions do.
def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 h0: torch.Tensor | None = None):
    """Sequential Mamba-2 SSD recurrence (the oracle of the chunked forms):
    ``h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t)``, ``y_t = h_t C_t``.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    h = (torch.zeros((Bt, H, P, N), device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])[..., None, None]     # (Bt, H, 1, 1)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) \
            * Bf[:, t, None, None, :]
        h = decay * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((Bt, 0, H, P))
    return y.to(x.dtype), h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                h0: torch.Tensor | None = None, chunk: int = 128):
    """Chunked SSD (plain ``ssd_scan``), the same matrix form as the
    reference's ``ssd_chunked``: per chunk of T steps, y = ((C B^T) o M)
    (dt o X) + exp(cum) (C . h) with M[t, s] = exp(cum_t - cum_s) for
    s <= t, and h' = exp(cum_T) h + X^T diag(dt exp(cum_T - cum)) B.  A
    ragged tail is padded with dt = 0 (a no-op on the state)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if S == 0:
        return ssd_scan_ref(x, dt, A, B, C, h0)
    chunk = min(chunk, S)
    pad = (-S) % chunk

    def padded(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bt, pad) + t.shape[2:])], 1)
        return t

    xf, dtf, Bf, Cf = (padded(t) for t in (x, dt, B, C))
    Af = A.float()
    h = (torch.zeros((Bt, H, P, N), device=x.device) if h0 is None
         else h0.float())
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(Af * dtc, 1)                       # (Bt, T, H)
        logm = cum[:, :, None, :] - cum[:, None, :, :]        # (Bt, T, T, H)
        m = torch.where(tri, torch.exp(logm.clamp(max=0.0)), 0.0)
        w = (Cc @ Bc.transpose(1, 2))[..., None] * m          # (Bt, T, T, H)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xc * dtc[..., None])
        cdecay = Cc[:, :, None, :] * torch.exp(cum)[..., None]
        y_carry = torch.einsum("bthn,bhpn->bthp", cdecay, h)
        wvec = dtc * torch.exp(cum[:, -1:] - cum)             # (Bt, T, H)
        upd = torch.einsum("bthp,bth,btn->bhpn", xc, wvec, Bc)
        h = torch.exp(cum[:, -1])[..., None, None] * h + upd
        ys.append(y_intra + y_carry)
    y = torch.cat(ys, 1)[:, :S]
    return y.to(x.dtype), h


def ssd_chunked_tc(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   h0: torch.Tensor | None = None, chunk: int = 64):
    """The ``ssd_scan`` kernel's tensor-core design in plain PyTorch (tests
    only): :func:`ssd_chunked`'s form at the kernel's chunk, with its
    roundings.  Per chunk, G = C B^T in float32 once per sequence (not per
    head); W = G o M o dt rounded to bfloat16; y = W X + exp(cum) o (C .
    h_bf16) with the state rounded to bfloat16 as the operand; X' = x o dt
    exp(cum_T - cum) rounded to bfloat16 and h' = exp(cum_T) h + X'^T B.
    Sums are float32 and the carried state stays float32; a ragged tail is
    padded with dt = 0."""
    Bt, S, H, P = x.shape
    if S == 0:
        return ssd_scan_ref(x, dt, A, B, C, h0)
    pad = (-S) % chunk

    def padded(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bt, pad) + t.shape[2:])], 1)
        return t

    def bf16(t):
        return t.to(torch.bfloat16).float()

    xf, dtf, Bf, Cf = (padded(t) for t in (x, dt, B, C))
    Af = A.float()
    h = (torch.zeros((Bt, H, P, B.shape[-1]), device=x.device)
         if h0 is None else h0.float())
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(Af * dtc, 1)                       # (Bt, T, H)
        g = Cc @ Bc.transpose(1, 2)                           # (Bt, T, T)
        logm = cum[:, :, None, :] - cum[:, None, :, :]        # (Bt, T, T, H)
        m = torch.where(tri, torch.exp(logm.clamp(max=0.0)), 0.0)
        w = bf16(g[..., None] * m * dtc[:, None])             # (Bt, T, T, H)
        y_carry = torch.einsum("btn,bhpn->bthp", Cc, bf16(h)) \
            * torch.exp(cum)[..., None]
        ys.append(y_carry + torch.einsum("btsh,bshp->bthp", w, xc))
        xs = bf16(xc * (dtc * torch.exp(cum[:, -1:] - cum))[..., None])
        h = torch.exp(cum[:, -1])[..., None, None] * h \
            + torch.einsum("bthp,btn->bhpn", xs, Bc)
    y = torch.cat(ys, 1)[:, :S]
    return y.to(x.dtype), h
