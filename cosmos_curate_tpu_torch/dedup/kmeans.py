"""Spherical k-means on one card: the semantic-dedup core (port of
``cosmos_curate_tpu/dedup/kmeans.py``).

The JAX package shards the rows over a mesh and lets XLA insert the
centroid psum; on one card the port runs its single-device path (the JAX
package does the same for a mesh of one device). Every product is a plain
``torch.matmul`` in fp32 with TF32 off for its duration (``_fp32``), so a
near-tie breaks as it does in fp32 whatever precision the process set
elsewhere. ``argmax`` / ``argmin`` return the first index on ties, as
``jnp``'s do. The centroid sums are an ``index_add_`` over the rows, never a
dense ``[N, K]`` one-hot (4.3 GB at N = 2^20, K = 1024).

The first centroid of the greedy seeding is a row drawn uniformly from an
explicit ``torch.Generator`` seeded with ``seed`` (``_first_index``): the
JAX package draws it with ``jax.random.choice``, which a torch generator
cannot reproduce. Everything after that first index is the reference's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def _fp32(device: torch.device):
    """True fp32 matmuls for the block: cuBLAS's TF32 off on the GPU,
    restored on exit."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _first_index(valid: int, seed: int) -> int:
    """The first seed centroid: a uniform draw over the ``valid`` rows."""
    gen = torch.Generator().manual_seed(seed)
    return int(torch.randint(valid, (1,), generator=gen))


def _init_centroids(data: torch.Tensor, k: int, first: int, valid: int) -> torch.Tensor:
    """Greedy k-means++-style seeding: row ``first`` is the first centroid,
    each next one the row FURTHEST (lowest max cosine similarity) from every
    centroid chosen so far. Rows at or beyond ``valid`` are masked out."""
    n = data.shape[0]
    mask = torch.arange(n, device=data.device) < valid
    cents = torch.zeros((k, data.shape[1]), dtype=data.dtype, device=data.device)
    c = data[first]
    cents[0] = c
    best = data @ c  # max similarity to any chosen centroid
    inf = torch.tensor(float("inf"), device=data.device)
    for j in range(1, k):
        idx = torch.argmin(torch.where(mask, best, inf)).view(1)
        # index_select keeps the index on the device: no sync per centroid
        c = data.index_select(0, idx)[0]
        cents[j] = c
        best = torch.maximum(best, data @ c)
    return cents


def _lloyd_step(data: torch.Tensor, centroids: torch.Tensor, valid: int):
    """One Lloyd iteration over ``data`` ``[N, D]`` (rows at or beyond
    ``valid`` are padding) and ``centroids`` ``[K, D]``. Returns
    (new_centroids, assignments, shift)."""
    k = centroids.shape[0]
    sims = data @ centroids.T  # [N, K]
    assign = torch.argmax(sims, dim=1)
    del sims
    rows = assign[:valid]
    sums = torch.zeros_like(centroids).index_add_(0, rows, data[:valid])
    counts = torch.bincount(rows, minlength=k).to(data.dtype)[:, None]
    new = torch.where(counts > 0, sums / counts.clamp(min=1), centroids)
    norms = torch.linalg.norm(new, dim=1, keepdim=True)
    new = new / norms.clamp(min=1e-8)
    shift = torch.linalg.norm(new - centroids, dim=1).max()
    return new, assign, shift


def normalize_rows(embeddings: np.ndarray) -> np.ndarray:
    """Rows over their L2 norm (at least 1e-8), on the host, as the
    reference normalises before clustering and pruning."""
    return embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-8)


def kmeans_fit(
    embeddings: np.ndarray,
    k: int,
    *,
    iters: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Fit spherical k-means on ``device`` ("cuda" unless the caller asks for
    the CPU); returns (centroids ``[K, D]``, assignments ``[N]``) on the
    host. Embeddings are L2-normalised first (cosine geometry)."""
    dev = model_device(device, "k-means")
    n = embeddings.shape[0]
    k = min(k, n)
    data = torch.as_tensor(normalize_rows(embeddings), dtype=torch.float32).to(dev)
    with _fp32(dev):
        centroids = _init_centroids(data, k, _first_index(n, seed), n)
        assign = None
        for i in range(iters):
            centroids, assign, shift = _lloyd_step(data, centroids, n)
            if float(shift) < tol:
                logger.info("kmeans converged after %d iters (shift %.2e)", i + 1, float(shift))
                break
    return centroids.cpu().numpy(), assign.cpu().numpy()


def semantic_dedup(
    embeddings: np.ndarray,
    ids: list[str],
    *,
    n_clusters: int | None = None,
    eps: float = 0.07,
    iters: int = 20,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """SemDeDup-style pruning: cluster on ``device``, then, on the host as
    in the reference, walk the clusters in sorted order and each cluster's
    members in index order, dropping an item whose cosine similarity to an
    already kept item of its cluster exceeds ``1 - eps``.

    Returns {"kept": [...], "removed": [...], "duplicate_of": {id: id},
    "assignments": np.ndarray}."""
    device = model_device(device, "k-means")
    n = len(ids)
    if n == 0:
        return {"kept": [], "removed": [], "duplicate_of": {}, "assignments": np.zeros(0, int)}
    k = n_clusters or max(1, int(np.sqrt(n)))
    _, assign = kmeans_fit(embeddings, k, iters=iters, seed=seed, device=device)
    normed = normalize_rows(embeddings)
    kept: list[str] = []
    removed: list[str] = []
    duplicate_of: dict[str, str] = {}
    threshold = 1.0 - eps
    for c in np.unique(assign):
        members = np.flatnonzero(assign == c)
        sims = normed[members] @ normed[members].T  # small per-cluster block
        kept_local: list[int] = []
        for j, m in enumerate(members):
            dup_idx = next((kl for kl in kept_local if sims[j, kl] > threshold), None)
            if dup_idx is None:
                kept_local.append(j)
                kept.append(ids[m])
            else:
                removed.append(ids[m])
                duplicate_of[ids[m]] = ids[members[dup_idx]]
    return {"kept": kept, "removed": removed, "duplicate_of": duplicate_of, "assignments": assign}
