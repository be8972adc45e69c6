"""Synthetic matrix generators for tests and benchmarks.

The reference benchmarks 30 SuiteSparse matrices fetched over the
network (scripts/download-matrices.py:7-38). This environment has no
egress, so we synthesize matrices with the same structural archetypes
the suite spans (SURVEY.md section 6):

* ``banded``   — FEM-like: clustered diagonal band, regular row lengths
                 (cant, ML_Laplace, af_1_k101, ...);
* ``random``   — uniform scatter (mac_econ-like);
* ``powerlaw`` — Zipf column popularity + skewed row lengths
                 (webbase-1M, wiki-Talk, dc1);
* ``diag``     — trivial diagonal (degenerate edge case);
* plus tiny handwritten matrices in the tests.

All generators are deterministic (seeded) like the reference's unseeded
``rand()`` x (vector.c:36-41).
"""

from __future__ import annotations

import numpy as np

from spmv_scpa_tpu.formats.csr import CSR


def banded_csr(m: int, n: int | None = None, row_nnz: int = 32,
               bandwidth: int = 256, seed: int = 0, runs: int = 0,
               name: str = "synth_banded") -> CSR:
    """Clustered band: each row gets ``row_nnz`` columns near the
    diagonal within ``bandwidth`` — FEM archetype.

    ``runs > 0`` emits the nonzeros as that many *contiguous* column
    runs per row (real FEM matrices store dense multi-dof blocks, which
    is why their nonzeros come in consecutive-column runs); ``runs=0``
    scatters them uniformly over the band (a pessimistic layout for
    padded formats)."""
    n = n or m
    rng = np.random.default_rng(seed)
    center = (np.arange(m, dtype=np.float64) * n / m).astype(np.int64)
    if runs > 0:
        runs = min(runs, row_nnz)
        run_len = row_nnz // runs
        starts = rng.integers(-bandwidth // 2, bandwidth // 2 + 1,
                              size=(m, runs))
        cols = (center[:, None, None] + starts[:, :, None]
                + np.arange(run_len)[None, None, :]).reshape(m, -1)
        cols = np.clip(cols, 0, n - 1)
        rows = np.repeat(np.arange(m), cols.shape[1])
        cols = cols.reshape(-1)
    else:
        rows = np.repeat(np.arange(m), row_nnz)
        off = rng.integers(-bandwidth // 2, bandwidth // 2 + 1,
                           size=rows.shape[0])
        cols = np.clip(np.repeat(center, row_nnz) + off, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    # dedup (row, col) to keep nnz counts honest
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return CSR.from_coo(name, m, n, rows[first], cols[first], vals[first])


def stencil_csr(m: int, n: int | None = None, points: int = 6,
                run_len: int = 12, bandwidth: int = 500, seed: int = 0,
                name: str = "synth_stencil") -> CSR:
    """Stencil/FEM archetype: every row has the SAME set of
    ``points`` contiguous runs at fixed offsets from the diagonal
    (jittered only between 8-row blocks). This matches
    Laplacian/stencil-discretization matrices (ML_Laplace-type): mesh
    node numbering makes neighboring rows share their element
    neighborhoods, so nonzero patterns repeat down the band — unlike
    ``banded_csr(runs=...)`` whose per-row-independent runs are a
    pessimistic (scattered) band."""
    n = n or m
    rng = np.random.default_rng(seed)
    base_off = np.sort(rng.integers(-bandwidth // 2, bandwidth // 2,
                                    size=points))
    nblocks = -(-m // 8)
    jitter = rng.integers(-8, 9, size=(nblocks, points))
    off = base_off[None, :] + jitter                    # (nblocks, points)
    rows = np.repeat(np.arange(m), points * run_len)
    centers = np.arange(m, dtype=np.int64)
    starts = off[np.arange(m) // 8]                     # (m, points)
    cols = (centers[:, None, None] + starts[:, :, None]
            + np.arange(run_len)[None, None, :]).reshape(-1)
    cols = np.clip(cols, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return CSR.from_coo(name, m, n, rows[first], cols[first], vals[first])


def random_csr(m: int, n: int | None = None, density: float = 0.01,
               seed: int = 0, name: str = "synth_random") -> CSR:
    n = n or m
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(first.shape[0])
    return CSR.from_coo(name, m, n, rows[first], cols[first], vals)


def powerlaw_csr(m: int, n: int | None = None, avg_nnz: int = 8,
                 alpha: float = 1.5, seed: int = 0,
                 name: str = "synth_powerlaw") -> CSR:
    """Zipf-popular columns and skewed row lengths — the webbase /
    wiki-Talk archetype that stresses load balancing (SURVEY.md 7,
    hard part #3)."""
    n = n or m
    rng = np.random.default_rng(seed)
    # Skewed row lengths (some rows huge)
    lens = np.minimum(rng.zipf(alpha, size=m), n // 2)
    total = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    # Zipf column popularity
    cols = (rng.zipf(alpha, size=total) - 1) % n
    scatter = rng.integers(0, n, total)
    use_scatter = rng.random(total) < 0.3
    cols = np.where(use_scatter, scatter, cols)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(first.shape[0])
    return CSR.from_coo(name, m, n, rows[first], cols[first], vals)


def webbase_csr(m: int = 1_000_000, avg_nnz: float = 3.1,
                local_frac: float = 0.8, locality: int = 2000,
                alpha: float = 1.8, copy_frac: float = 0.55,
                site_mean: int = 64, pool_k: int = 12, seed: int = 0,
                name: str = "synth_webbase") -> CSR:
    """Structurally faithful webbase-1M stand-in (the reference's
    hardest power-law matrix: 1M rows, ~3.1M nnz, best CUDA CSR ≈ 14
    GFLOPS — BASELINE.md).

    Web-graph structure, unlike ``powerlaw_csr``'s uniform scatter:

    * **Copying model** (Kumar et al., the standard web-graph
      generative model): pages within a *site* (run of ``~site_mean``
      consecutive page ids — crawls emit sites contiguously) share a
      common link pool (nav bars, footers, site indexes), so
      ``copy_frac`` of each page's links repeat site-mates' targets.
      This row-to-row column-set correlation is what makes the
      reference's cached-x CSR kernel reach 14 GFLOPS on the real
      matrix (cuda_csr.cu:145-178); without it every x access misses.
    * Remaining links: ~``local_frac`` INTRA-DOMAIN (within
      ``locality`` of the diagonal), rest to Zipf-popular global hubs.
    * Row lengths are Zipf (most pages have few outlinks).

    ``powerlaw_csr`` remains the adversarial no-correlation stress
    case (dc1-like, where the reference too collapses to ~3 GFLOPS).
    """
    n = m
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(alpha, size=m), 50_000)
    # scale to the target average
    total_target = int(m * avg_nnz)
    lens = np.maximum(1, (lens * (total_target / lens.sum())).astype(
        np.int64))
    total = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    local = rng.integers(-locality, locality + 1, size=total)
    hub = (rng.zipf(1.3, size=total) - 1) % n
    use_local = rng.random(total) < local_frac
    cols = np.where(use_local, np.clip(rows + local, 0, n - 1), hub)
    if copy_frac > 0.0:
        # sites: geometric runs of consecutive pages, mean site_mean
        nsites = max(1, int(2.2 * m / site_mean))
        sizes = rng.geometric(1.0 / site_mean, size=nsites)
        site_of = np.repeat(np.arange(nsites),
                            sizes)[:m].astype(np.int64)
        if site_of.shape[0] < m:          # pad if sizes fell short
            site_of = np.concatenate(
                [site_of, np.full(m - site_of.shape[0], nsites - 1,
                                  np.int64)])
        site_start = np.full(nsites, m - 1, np.int64)
        np.minimum.at(site_start, site_of, np.arange(m))
        # per-site shared pool: mostly the site's OWN pages (nav/footer
        # links target the site index — a few-hundred-id range), + hubs
        pool_loc = rng.integers(0, 3 * site_mean, size=(nsites, pool_k))
        pool = np.clip(site_start[:, None] + pool_loc, 0, n - 1)
        pool_hub = (rng.zipf(1.3, size=(nsites, pool_k)) - 1) % n
        is_hub = rng.random((nsites, pool_k)) < 0.25
        pool = np.where(is_hub, pool_hub, pool)
        pick = rng.integers(0, pool_k, size=total)
        copied = pool[site_of[rows], pick]
        cols = np.where(rng.random(total) < copy_frac, copied, cols)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(first.shape[0])
    return CSR.from_coo(name, m, n, rows[first], cols[first], vals)


def amazon_csr(m: int = 262_000, avg_nnz: float = 4.7,
               local_frac: float = 0.9, locality: int = 300,
               alpha: float = 3.0, copy_frac: float = 0.5,
               site_mean: int = 32, pool_k: int = 8, seed: int = 0,
               name: str = "synth_amazon") -> CSR:
    """amazon0302-style co-purchase graph stand-in (262k rows, ~1.2M
    nnz, avg ~4.7/row): the reference's power-law-WITH-locality case,
    where HLL beats CSR (37 vs 31 GFLOPS — BASELINE.md row 3). Same
    copying-model generator as ``webbase_csr`` but with tight locality
    (co-purchased items are catalog neighbors), thin-tailed out-degree
    (alpha=3: product pages link a handful of items, no mega-hubs),
    and small shared pools. Completes the scattered-matrix spectrum:
    amazon (local) / webbase (mixed) / powerlaw (adversarial)."""
    return webbase_csr(m=m, avg_nnz=avg_nnz, local_frac=local_frac,
                       locality=locality, alpha=alpha,
                       copy_frac=copy_frac, site_mean=site_mean,
                       pool_k=pool_k, seed=seed, name=name)


def diag_csr(m: int, name: str = "synth_diag") -> CSR:
    i = np.arange(m)
    return CSR.from_coo(name, m, m, i, i, 1.0 + i.astype(np.float64))


def tiny_fixture_csr() -> CSR:
    """4x5 handwritten matrix with an empty row and a duplicate-free
    irregular pattern — the cage4-style smallest unit test case."""
    dense = np.array([
        [1.0, 0.0, 2.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 3.0, 0.0, 0.0, 4.5],
        [5.0, 0.0, 0.0, -1.0, 0.0],
    ])
    return CSR.from_dense("tiny", dense)


ARCHETYPES = {
    "banded": banded_csr,
    "stencil": stencil_csr,
    "random": random_csr,
    "powerlaw": powerlaw_csr,
    "webbase": webbase_csr,
    "amazon": amazon_csr,
}

# The flagship: the ML_Laplace-scale stand-in (377k rows, ~22.6M nnz,
# ~60 nnz/row in repeated contiguous runs; ~270 MB of f32 CSR, several
# times a GPU's L2), as a ``synth:`` spec for the CLI's parser.
FLAGSHIP_SPEC = "synth:stencil:m=377000,points=6,run_len=12,bandwidth=500,seed=3"
