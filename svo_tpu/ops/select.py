"""Grid-bucketed feature selection as dense per-cell top-k.

First-class resurrection of the reference's dead bucketing code
(reference: include/bucket.h, src/bucket.cpp — never called, TODO at
src/tracking.cpp:88) with its two latent bugs fixed by construction:
- bucket array sized (h+1)*(w+1) but indexed with stride w
  (src/bucket.cpp:38-53): here the grid is an exact reshape, no indexing bug
  possible;
- age-replacement comparing the incoming age to itself
  (src/bucket.cpp:84-93): here per-cell preference is an explicit top-k on a
  priority key.

Formulation: pad the score map to a multiple of the cell size, reshape to
(cells, cell_pixels), run top-k per cell (a dense segment-max), then a global
top-k over cell winners. Static output shape (max_out slots + validity mask).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _topk_rounds(cells: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """top-k per row via k max+mask rounds.

    For k << P, k rounds of (row-max, first-argmax, mask-out) are plain
    reductions, an alternative to lax.top_k that on the GPU has not been
    compared with it. Tie order matches lax.top_k (first index wins).

    Contract difference vs lax.top_k for EXHAUSTED rows (fewer than k
    entries above -inf): once a row runs out, every remaining round
    returns the SAME index (the row's first -inf slot) with value -inf,
    where top_k would return k distinct indices. Callers must therefore
    filter by value (bucketed_topk keeps `top_scores > 0`), not assume
    index uniqueness."""
    P = cells.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, cells.shape, cells.ndim - 1)
    work = cells
    vals, idxs = [], []
    for _ in range(k):
        m = jnp.max(work, axis=-1)
        i = jnp.min(
            jnp.where(work == m[..., None], iota, P), axis=-1
        )
        vals.append(m)
        idxs.append(jnp.minimum(i, P - 1))
        work = jnp.where(iota == i[..., None], -jnp.inf, work)
    return jnp.stack(vals, -1), jnp.stack(idxs, -1)


def bucketed_topk(
    score: jnp.ndarray,
    bucket_size: int,
    per_bucket: int,
    max_out: int,
    strong_gap: float = 0.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Select up to max_out features, at most per_bucket per grid cell.

    Args:
        score: (H, W) score map, 0 = not a candidate.
        bucket_size: cell side in pixels.
        per_bucket: per-cell cap.
        max_out: output slots.
        strong_gap: two-tier split — candidates with score > strong_gap form
            the STRONG tier and occupy the front of the selection order;
            candidates in (0, strong_gap] are the WEAK tier, appended after
            every strong one. With scores from fast.fast_score at a lowered
            threshold, strong_gap = (normal - low) makes the strong tier
            exactly the normal-threshold detections, and weak corners only
            claim slots the strong tier leaves free (adaptive-threshold
            starvation rescue; 0 disables = single tier).
    Returns:
        pos (max_out, 2) float32 (x, y); score (max_out,); valid (max_out,).
    """
    H, W = score.shape
    B = bucket_size
    Hp = -(-H // B) * B
    Wp = -(-W // B) * B
    s = jnp.pad(score, ((0, Hp - H), (0, Wp - W)))
    hc, wc = Hp // B, Wp // B
    cells = s.reshape(hc, B, wc, B).transpose(0, 2, 1, 3).reshape(hc * wc, B * B)

    k = min(per_bucket, B * B)
    cell_scores, cell_idx = _topk_rounds(cells, k)  # (C, k)

    # flat pixel coordinates of each cell winner
    cy = jnp.arange(hc * wc) // wc
    cx = jnp.arange(hc * wc) % wc
    py = cy[:, None] * B + cell_idx // B
    px = cx[:, None] * B + cell_idx % B

    flat_scores = cell_scores.reshape(-1)
    flat_x = px.reshape(-1)
    flat_y = py.reshape(-1)

    # ROUND-ROBIN allocation across cells with a SPATIAL-SPREAD order
    # (round-4 robustness fix): rank candidates by within-cell rank first
    # (every cell's best wins a slot before any cell's second-best), and
    # WITHIN a rank by a golden-ratio permutation of the cell index rather
    # than by score. A plain global top-k let one high-contrast region
    # (e.g. an aliased far wall) absorb the whole budget and starve the
    # near ground — which starved triangulation and collapsed the pipeline
    # on turn-heavy worlds; score-ordering within the rank reproduced the
    # same starvation whenever downstream slots truncate the list (the
    # keyframe merge takes the first ~free-slot-count entries). The
    # golden-ratio order makes ANY prefix of the output near-uniform over
    # the image. This is the spatial-diversity semantics the reference's
    # dead bucketing code intended (src/bucket.cpp:72-101), strengthened.
    # The key is an INT32 composite (tier, rank, cell-spread) — float
    # magnitude mixing collapsed within-rank order to ties at fine grids
    # (ADVICE r04): priority = tier * T + rank, ordered ascending, with the
    # golden-ratio cell permutation breaking ties within a (tier, rank)
    # level. C*k is at most a few thousand, so the composite is exact.
    C = cells.shape[0]
    rank = jnp.broadcast_to(
        jnp.arange(k, dtype=jnp.int32)[None, :], cell_scores.shape
    ).reshape(-1)
    cell_of = jnp.arange(C, dtype=jnp.float32)
    spread = jnp.floor(((cell_of * 0.6180339887) % 1.0) * C).astype(jnp.int32)
    spread = jnp.broadcast_to(spread[:, None], cell_scores.shape).reshape(-1)
    weak = (flat_scores <= strong_gap).astype(jnp.int32) if strong_gap > 0 else 0
    prio = (weak * k + rank) * (C + 1) + spread  # ascending = better first
    key = jnp.where(flat_scores > 0.0, -prio, jnp.iinfo(jnp.int32).min)
    top_key, top_i = jax.lax.top_k(key, min(max_out, key.shape[0]))
    top_scores = flat_scores[top_i]
    out_x = flat_x[top_i].astype(jnp.float32)
    out_y = flat_y[top_i].astype(jnp.float32)
    valid = (top_key > jnp.iinfo(jnp.int32).min) & (top_scores > 0.0)

    n = top_scores.shape[0]
    if n < max_out:
        pad = max_out - n
        out_x = jnp.pad(out_x, (0, pad))
        out_y = jnp.pad(out_y, (0, pad))
        top_scores = jnp.pad(top_scores, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    pos = jnp.stack([out_x, out_y], axis=-1)
    return pos, top_scores, valid


def global_topk(
    score: jnp.ndarray, max_out: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Plain global top-k selection from a score map (bucketing disabled).
    Scores <= 0 are treated as non-candidates."""
    H, W = score.shape
    flat = score.reshape(-1)
    top_scores, top_i = jax.lax.top_k(flat, max_out)
    pos = jnp.stack(
        [(top_i % W).astype(jnp.float32), (top_i // W).astype(jnp.float32)], axis=-1
    )
    return pos, top_scores, top_scores > 0.0


def global_topk_signed(
    score: jnp.ndarray, max_out: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-k where scores may be negative (e.g. Harris response); -inf marks
    non-candidates."""
    H, W = score.shape
    flat = score.reshape(-1)
    top_scores, top_i = jax.lax.top_k(flat, max_out)
    pos = jnp.stack(
        [(top_i % W).astype(jnp.float32), (top_i // W).astype(jnp.float32)], axis=-1
    )
    return pos, top_scores, jnp.isfinite(top_scores)
