"""Masked segment reductions keyed by cluster id.

The reference iterates `std::vector<int> occupy_pts` per cluster for bounding
boxes, centroids and counts (src/ssc.cpp:421-435, 437-445); here every
per-cluster quantity is one segment reduction over the padded point batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _seg_ids(ids: jnp.ndarray, valid: jnp.ndarray, num: int) -> jnp.ndarray:
    """Route invalid entries to an overflow bucket `num`."""
    return jnp.where(valid & (ids >= 0), ids, num)


def segment_sum(x: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray,
                num: int) -> jnp.ndarray:
    seg = _seg_ids(ids, valid, num)
    zero = jnp.zeros_like(x)
    return jax.ops.segment_sum(jnp.where(valid[..., None] if x.ndim > 1
                                         else valid, x, zero),
                               seg, num_segments=num + 1)[:num]


def segment_count(ids: jnp.ndarray, valid: jnp.ndarray, num: int
                  ) -> jnp.ndarray:
    seg = _seg_ids(ids, valid, num)
    return jax.ops.segment_sum(valid.astype(jnp.int32), seg,
                               num_segments=num + 1)[:num]


def grid_label_counts(labels: jnp.ndarray, num: int,
                      weights: jnp.ndarray | None = None,
                      weight_bound: int = 65536) -> jnp.ndarray:
    """Histogram of labels in [0, num) over a LARGE flat array (e.g. the
    [G]~1.3M voxel grid); entries outside [0, num) are ignored. With
    `weights` (same shape, f32) the histogram is weight-summed instead of
    counted (returned as f32; counts return int32).

    Instead of a segment-sum scatter the histogram is an OUTER-PRODUCT
    MATMUL: with label = hi*L + lo,
    count[hi, lo] = sum_g 1{hi_g=hi} * w_g * 1{lo_g=lo}
    = (onehot_hi [H, G]) @ (w-scaled onehot_lo [G, L]) - one matmul,
    exact in f32 accumulation up to 2^24 per bin for counts. The matmul
    form was chosen for the previous accelerator; against segment_sum on
    the H100 it is queued for measurement.

    `weight_bound`: exclusive upper bound on integer weight values; the
    radix-256 split uses exactly ceil(log256(weight_bound)) digit matmuls,
    so exactness holds for any weights < weight_bound (callers with
    per-voxel point counts should pass cfg.shapes.max_points + 1).
    """
    L = 32
    H = -(-num // L)
    hi = labels // L
    lo = labels % L          # Python-sign mod: negative labels -> hi < 0
    a = (hi[None, :] == jnp.arange(H, dtype=labels.dtype)[:, None])
    b = (lo[:, None] == jnp.arange(L, dtype=labels.dtype)[None, :])
    if weights is None:
        counts = jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
        return counts.reshape(H * L)[:num].astype(jnp.int32)
    # EXACT bf16 matmuls via a radix-256 weight split (instead of f32
    # 'highest' matmuls, a choice made for the previous accelerator):
    # integer
    # weights split into base-256 digits < 256, each bf16-exact,
    # accumulated in f32. Digit count follows `weight_bound` so weights
    # up to the declared bound lose nothing.
    n_digits = max(1, -(-max(weight_bound - 1, 1).bit_length() // 8))
    ab = a.astype(jnp.bfloat16)
    bf = b.astype(jnp.bfloat16)
    w = weights
    total = jnp.zeros((H, L), jnp.float32)
    scale = 1.0
    for _ in range(n_digits):
        w_next = jnp.floor(w / 256.0)
        digit = w - 256.0 * w_next
        total = total + scale * jnp.matmul(
            ab, bf * digit[:, None].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        w = w_next
        scale *= 256.0
    return total.reshape(H * L)[:num]


def grid_label_hist_multi(labels: jnp.ndarray, num: int,
                          weights: list, weight_bound: int
                          ) -> tuple[jnp.ndarray, list]:
    """(plain counts, [weighted histograms...]) over a large label array
    in ONE shared one-hot formation: the [G,L]/[H,G] one-hot planes
    dominate the matmul cost at G~1.3M, so every extra weight vector
    rides the same matmul for ~the marginal RHS columns only. Exactness
    contract of grid_label_counts (radix-256 split per weight, digit
    count from `weight_bound`)."""
    L = 32
    H = -(-num // L)
    hi = labels // L
    lo = labels % L
    ab = (hi[None, :] == jnp.arange(H, dtype=labels.dtype)[:, None]
          ).astype(jnp.bfloat16)
    bf = (lo[:, None] == jnp.arange(L, dtype=labels.dtype)[None, :]
          ).astype(jnp.bfloat16)
    n_digits = max(1, -(-max(weight_bound - 1, 1).bit_length() // 8))
    cols = [bf]
    for w0 in weights:
        w = w0
        for _ in range(n_digits):
            w_next = jnp.floor(w / 256.0)
            cols.append(bf * (w - 256.0 * w_next)[:, None
                                                  ].astype(jnp.bfloat16))
            w = w_next
    out = jnp.matmul(ab, jnp.concatenate(cols, axis=1),
                     preferred_element_type=jnp.float32)
    counts = out[:, :L].reshape(H * L)[:num].astype(jnp.int32)
    sums = []
    for i in range(len(weights)):
        wsum = jnp.zeros((H, L), jnp.float32)
        scale = 1.0
        for d in range(n_digits):
            k = 1 + i * n_digits + d
            wsum = wsum + scale * out[:, k * L:(k + 1) * L]
            scale *= 256.0
        sums.append(wsum.reshape(H * L)[:num])
    return counts, sums


def grid_label_hist2(labels: jnp.ndarray, num: int, weights: jnp.ndarray,
                     weight_bound: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(weighted histogram, plain counts) sharing one one-hot formation;
    see grid_label_hist_multi."""
    counts, (wsum,) = grid_label_hist_multi(labels, num, [weights],
                                            weight_bound)
    return wsum, counts


def small_table_lookup(table: jnp.ndarray, idx: jnp.ndarray,
                       bits: int) -> jnp.ndarray:
    """table[idx] for a SMALL unsigned-integer table WITHOUT a hardware
    gather: entries (< 2**bits each) pack into uint32 words, the word is
    picked by a masked-compare select tree (ceil(C*bits/32) passes over
    `idx`), and the entry is shifted out.

    Why: gathers were the expensive operation on the previous
    accelerator; against a plain `table[idx]` on the H100 it is queued
    for measurement.
    Use for per-voxel/per-point lookups of per-cluster or per-patch
    flags - any idx-shaped read of a table with C <= ~1k rows.

    `idx` must be pre-clipped to [0, C); any shape. Returns int32 (or
    bool if the table is bool and bits == 1).
    """
    was_bool = table.dtype == jnp.bool_
    C = table.shape[0]
    per = 32 // bits
    nw = -(-C // per)
    ent = jnp.arange(C)
    words = jax.ops.segment_sum(
        (table.astype(jnp.uint32)
         << ((ent % per) * bits).astype(jnp.uint32)),
        ent // per, num_segments=nw)
    hi = idx // per
    w = jnp.zeros(idx.shape, jnp.uint32)
    for k in range(nw):
        w = jnp.where(hi == k, words[k], w)
    out = ((w >> ((idx % per) * bits).astype(jnp.uint32))
           & jnp.uint32(2 ** bits - 1)).astype(jnp.int32)
    return out.astype(bool) if was_bool and bits == 1 else out


def segment_min(x: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray,
                num: int, fill: float = jnp.inf) -> jnp.ndarray:
    seg = _seg_ids(ids, valid, num)
    mask = valid[..., None] if x.ndim > 1 else valid
    xm = jnp.where(mask, x, fill)
    return jax.ops.segment_min(xm, seg, num_segments=num + 1)[:num]


def segment_max(x: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray,
                num: int, fill: float = -jnp.inf) -> jnp.ndarray:
    seg = _seg_ids(ids, valid, num)
    mask = valid[..., None] if x.ndim > 1 else valid
    xm = jnp.where(mask, x, fill)
    return jax.ops.segment_max(xm, seg, num_segments=num + 1)[:num]


def segment_minmax(x: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray,
                   num: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-segment (min, max) of [N,D] coordinates in ONE wide scatter:
    min over [x | -x] columns (max = -min of the negation): one
    2D-column segment_min pays a scatter's fixed cost once instead of
    twice for separate segment_min + segment_max."""
    seg = _seg_ids(ids, valid, num)
    xm = jnp.where(valid[:, None], x, jnp.inf)
    xn = jnp.where(valid[:, None], -x, jnp.inf)
    both = jnp.concatenate([xm, xn], axis=-1)
    out = jax.ops.segment_min(both, seg, num_segments=num + 1)[:num]
    D = x.shape[-1]
    return out[:, :D], -out[:, D:]


def segment_minmax_bcast(x: jnp.ndarray, ids: jnp.ndarray,
                         valid: jnp.ndarray, num: int, block: int = 8192
                         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-segment (min, max) WITHOUT a scatter: chunked broadcast-compare
    reduction: each `block` chunk builds the virtual [block, num, 2D]
    masked tensor and min-reduces it - XLA fuses the mask into the
    reduction, so nothing is materialized and the whole thing is
    ~N*num*2D select+min operations. Chosen over the scatter for the
    previous accelerator; on the H100 the two are queued for comparison.

    Bit-identical to segment_minmax (min/max over exactly the same
    member sets; empty segments return +inf/-inf before the caller's
    `alive` mask, same as the scatter path)."""
    N, D = x.shape
    both = jnp.concatenate([x, -x], axis=-1)
    both = jnp.where(valid[:, None] & (ids >= 0)[:, None], both, jnp.inf)
    nb = -(-N // block)
    pad = nb * block - N
    bothp = jnp.pad(both, ((0, pad), (0, 0)), constant_values=jnp.inf)
    idsp = jnp.pad(ids, (0, pad), constant_values=-1)
    cid = jnp.arange(num, dtype=ids.dtype)

    def chunk(carry, inp):
        b, i = inp                                     # [block,2D], [block]
        hit = i[:, None] == cid[None, :]               # [block, num]
        m = jnp.min(jnp.where(hit[:, :, None], b[:, None, :], jnp.inf),
                    axis=0)                            # [num, 2D]
        return jnp.minimum(carry, m), None

    init = jnp.full((num, 2 * D), jnp.inf, x.dtype)
    out, _ = jax.lax.scan(
        chunk, init, (bothp.reshape(nb, block, 2 * D),
                      idsp.reshape(nb, block)))
    return out[:, :D], -out[:, D:]


def segment_mean(x: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray,
                 num: int) -> jnp.ndarray:
    s = segment_sum(x, ids, valid, num)
    n = segment_count(ids, valid, num).astype(x.dtype)
    n = jnp.maximum(n, 1)
    return s / (n[..., None] if x.ndim > 1 else n)
