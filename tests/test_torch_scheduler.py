"""repro_torch.core.scheduler == repro.core.scheduler, exactly.

Seeded random index matrices (numpy) go through both packages' Alg-2
schedulers, table builders and layer compilers; schedules, tables and
utilizations must be bit-identical (``np.array_equal``, ``==`` on
floats): both packages must hand the kernels the same tables.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from repro.core import scheduler as jsch
from repro_torch.core import plan as pl
from repro_torch.core import scheduler as sch

# (N', K^2, r, alpha)
CASES = [(16, 64, 10, 4.0), (8, 64, 6, 2.0), (13, 16, 4, 4.0),
         (64, 64, 10, 4.0), (5, 36, 3, 8.0)]


def index_matrix(n, k2, alpha, seed):
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(k2 / alpha)))
    return np.sort(np.stack([rng.choice(k2, nnz, replace=False)
                             for _ in range(n)]), axis=1).astype(np.int32)


def layer_operands(n, m, k2, alpha, seed, bins=None):
    """indices [N, M, nnz] (drawn from ``bins`` when given) and dense
    complex values [N, M, K^2] with zeros off the support."""
    rng = np.random.default_rng(seed)
    pool = np.arange(k2) if bins is None else np.asarray(bins)
    nnz = max(1, int(round(k2 / alpha)))
    ind = np.sort(np.stack([[rng.choice(pool, nnz, replace=False)
                             for _ in range(m)] for _ in range(n)]),
                  axis=-1).astype(np.int32)
    vals = np.zeros((n, m, k2), np.complex64)
    w = (rng.standard_normal((n, m, nnz))
         + 1j * rng.standard_normal((n, m, nnz))).astype(np.complex64)
    np.put_along_axis(vals, ind.astype(np.int64), w, axis=-1)
    return ind, vals


def assert_same_schedule(a, b):
    assert (a.n_kernels, a.r, a.n_cycles, a.total_ops) == \
        (b.n_kernels, b.r, b.n_cycles, b.total_ops)
    for (ka, fa), (kb, fb) in zip(a.cycles, b.cycles):
        assert ka.dtype == kb.dtype and fa.dtype == fb.dtype
        assert np.array_equal(ka, kb) and np.array_equal(fa, fb)


def assert_same_tables(a, b):
    for name in ("index_table", "sel", "valid", "values", "out_index"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_scheduler_registry_matches():
    assert list(sch.SCHEDULERS) == list(jsch.SCHEDULERS)


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("n,k2,r,alpha", CASES)
def test_exact_cover_identical(n, k2, r, alpha, merge):
    for seed in range(3):
        mat = index_matrix(n, k2, alpha, seed)
        assert_same_schedule(sch.schedule_exact_cover(mat, k2, r, merge),
                             jsch.schedule_exact_cover(mat, k2, r, merge))


@pytest.mark.parametrize("n,k2,r,alpha", CASES)
def test_baselines_identical(n, k2, r, alpha):
    mat = index_matrix(n, k2, alpha, 7)
    assert_same_schedule(sch.schedule_lowest_index_first(mat, k2, r),
                         jsch.schedule_lowest_index_first(mat, k2, r))
    for seed in (0, 3):
        assert_same_schedule(sch.schedule_random(mat, k2, r, seed),
                             jsch.schedule_random(mat, k2, r, seed))


@pytest.mark.parametrize("method", list(jsch.SCHEDULERS))
@pytest.mark.parametrize("n,k2,r,alpha", CASES[:3])
def test_tables_and_active_bins_identical(n, k2, r, alpha, method):
    mat = index_matrix(n, k2, alpha, 11)
    rng = np.random.default_rng(12)
    vals = (rng.standard_normal((n, k2))
            + 1j * rng.standard_normal((n, k2))).astype(np.complex64)
    s_port = sch.SCHEDULERS[method](mat, k2, r)
    s_ref = jsch.SCHEDULERS[method](mat, k2, r)
    t_port = sch.build_tables(s_port, vals, mat)
    t_ref = jsch.build_tables(s_ref, vals, mat)
    assert_same_tables(t_port, t_ref)
    assert np.array_equal(sch.active_bins_from_tables(t_port),
                          jsch.active_bins_from_tables(t_ref))
    assert np.array_equal(sch.active_bins_from_tables([t_port, t_port]),
                          jsch.active_bins_from_tables([t_ref, t_ref]))
    x = (rng.standard_normal(k2)
         + 1j * rng.standard_normal(k2)).astype(np.complex64)
    assert np.array_equal(sch.execute_tables(t_port, x),
                          jsch.execute_tables(t_ref, x))
    sch.verify_schedule(s_port, mat, k2)


def assert_same_layer_tables(a, b):
    for name in ("idx", "sel", "vr", "vi"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.total_cycles == b.total_cycles
    assert a.pe_utilization == b.pe_utilization
    assert a.nbytes == b.nbytes


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n,m,n_par,r,m_pad_to", [
    (21, 11, 8, 6, 4),        # group remainder, padded channels,
                              # two pool blocks per group
    (16, 5, 16, 10, 1),
    (7, 3, 3, 4, 2),
])
def test_compile_layer_tables_identical(n, m, n_par, r, m_pad_to, compact):
    k2 = 64
    bins = np.sort(np.random.default_rng(5).choice(k2, 24, replace=False))
    ind, vals = layer_operands(n, m, k2, 4.0, seed=n + m,
                               bins=bins if compact else None)
    active = bins if compact else None
    ref = jsch.compile_layer_tables(ind, vals, k2, r, n_par, active=active,
                                    m_pad_to=m_pad_to)
    port = sch.compile_layer_tables(ind, vals, k2, r, n_par, active=active,
                                    m_pad_to=m_pad_to)
    assert_same_layer_tables(port, ref)
    with ThreadPoolExecutor(3) as pool:     # blocks out of order, same result
        pooled = sch.compile_layer_tables(ind, vals, k2, r, n_par,
                                          active=active, m_pad_to=m_pad_to,
                                          pool=pool)
    assert_same_layer_tables(pooled, ref)


def test_compile_layer_tables_in_process_pool():
    """The plan's spawn-context process pool gives the serial result."""
    ind, vals = layer_operands(12, 2 * sch.POOL_BLOCK + 1, 64, 4.0, seed=3)
    ref = jsch.compile_layer_tables(ind, vals, 64, 10, 8)
    with pl._schedule_pool(2) as pool:
        port = sch.compile_layer_tables(ind, vals, 64, 10, 8, pool=pool)
    assert_same_layer_tables(port, ref)


def child_processes() -> list[str]:
    """Command lines of this process's live children (Linux /proc)."""
    me = str(os.getpid())
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            if (d / "stat").read_text().rsplit(")", 1)[1].split()[1] == me:
                found.append((d / "cmdline").read_bytes()
                             .replace(b"\0", b" ").decode().strip())
        except OSError:         # the process ended while we looked
            continue
    return found


@pytest.mark.skipif(not Path("/proc/self/stat").exists(),
                    reason="needs Linux /proc to list child processes")
def test_schedule_pool_leaves_no_process():
    """The pool joins its workers and stops the resource tracker that
    spawn started, so a plan build leaves no helper process running."""
    before = child_processes()
    ind, vals = layer_operands(12, 2 * sch.POOL_BLOCK + 1, 64, 4.0, seed=3)
    with pl._schedule_pool(2) as pool:
        sch.compile_layer_tables(ind, vals, 64, 10, 8, pool=pool)
        assert len(child_processes()) > len(before)    # workers ran
    assert child_processes() == before


@pytest.mark.parametrize("method", list(jsch.SCHEDULERS))
@pytest.mark.parametrize("sample", [None, 2])
def test_simulate_layer_utilization_identical(method, sample):
    ind, _ = layer_operands(20, 5, 64, 4.0, seed=9)
    kw = dict(method=method, channel_sample=sample, seed=4)
    assert (sch.simulate_layer_utilization(ind, 64, 10, 8, **kw)
            == jsch.simulate_layer_utilization(ind, 64, 10, 8, **kw))


@pytest.mark.parametrize("fault", ["c1", "c2", "missing", "twice"])
def test_verify_schedule_raises_on_corruption(fault):
    mat = index_matrix(16, 64, 4.0, 21)
    s = sch.schedule_exact_cover(mat, 64, 4)
    sch.verify_schedule(s, mat, 64)
    cycles = [(k.copy(), f.copy()) for k, f in s.cycles]
    k0, f0 = cycles[0]
    if fault == "c1":              # one kernel twice in a cycle
        cycles[0] = (np.append(k0, k0[0]), np.append(f0, f0[0]))
    elif fault == "c2":            # more distinct indices than replicas
        extra = np.setdiff1d(np.arange(64), f0)[:5]
        free = np.setdiff1d(np.arange(16), k0)[:5]
        cycles[0] = (np.append(k0, free), np.append(f0, extra))
    elif fault == "missing":       # a non-zero never served
        cycles[0] = (k0[1:], f0[1:])
    else:                          # a non-zero served twice
        cycles.append((k0[:1], f0[:1]))
    bad = sch.Schedule(s.n_kernels, s.r, cycles)
    with pytest.raises(sch.PlanValidationError) as e:
        sch.verify_schedule(bad, mat, 64)
    assert isinstance(e.value, ValueError) and e.value.site == "verify_schedule"
    with pytest.raises(ValueError):
        jsch.verify_schedule(bad, mat, 64)
