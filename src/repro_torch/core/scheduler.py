"""Alg 2 — exact-cover based memory-access scheduling (paper §5.3);
counterpart of ``repro.core.scheduler``, in numpy (its errors and
fault sites are ``core.resilience``'s).

Problem: N' sparse kernels (rows of an index matrix, K^2/alpha non-zero
frequency indices each) read the same input tile held in BRAMs with r
replicas.  A *cycle* may serve at most one (value, index) per kernel (C1)
and touch at most r distinct indices (C2).  Rearranging each kernel's
value stream, find the minimum number of cycles covering every non-zero —
an exact-cover instance, approximated greedily:

  * if some candidate set covers ALL remaining kernels, choose the one
    built from low-degree index nodes (leave high-degree nodes free for
    future cycles);
  * otherwise choose the set covering the most kernels.

Implemented as greedy max-coverage with lexicographic tie-breaking
(coverage desc, then index-node degree asc), plus the two baselines the
paper compares against (random, lowest-index-first [16]) and a
cycle-accurate simulator that replays a schedule, checks C1/C2/exact-cover
and measures PE utilization (Eq 14).

The schedule compiles into the paper's Fig 6 storage layout: an INDEX
table [T, r] of replica read addresses and a VALUE table [T, N'] of
(weight, sel, valid) PE feeds.  ``compile_layer_tables`` stacks them for
a whole layer into the operands of the scheduled fused kernel
(``kernels.fused_spectral_conv.fused_spectral_pipeline_scheduled``).

Given the same inputs, every function here returns exactly what its
``repro.core.scheduler`` namesake returns (same tie-breaking, same
merge order), so both packages build bit-identical tables.
``compile_layer_tables`` may spread its independent (group, channel)
schedules over a process pool; results are assembled in the same
(group, channel) order.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Executor

import numpy as np

from repro_torch.core import resilience as res
from repro_torch.core.resilience import PlanValidationError


@dataclasses.dataclass
class Schedule:
    """A scheduling result for one group of N' kernels.

    cycles: list of (kernel_ids, index_ids) pairs per cycle, kernel_ids
            aligned with index_ids (the assigned read address per kernel).
    """

    n_kernels: int
    r: int
    cycles: list[tuple[np.ndarray, np.ndarray]]

    @property
    def n_cycles(self) -> int:
        return len(self.cycles)

    @property
    def total_ops(self) -> int:
        return sum(len(k) for k, _ in self.cycles)

    @property
    def pe_utilization(self) -> float:
        """Eq 14 with P' folded out (tiles share the schedule)."""
        if not self.cycles:
            return 1.0
        return self.total_ops / (self.n_cycles * self.n_kernels)


def _edges_from_matrix(index_matrix: np.ndarray, k2: int) -> np.ndarray:
    """[N', nnz] index matrix -> boolean incidence [N', K^2]."""
    n = index_matrix.shape[0]
    inc = np.zeros((n, k2), dtype=bool)
    rows = np.repeat(np.arange(n), index_matrix.shape[1])
    inc[rows, index_matrix.ravel()] = True
    return inc


def _assign_and_delete(inc: np.ndarray, active: np.ndarray,
                       chosen: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """Each covered kernel consumes one edge to a chosen index; prefer the
    chosen index with the lowest remaining degree (burn scarce nodes)."""
    deg = inc.sum(axis=0)
    order = sorted(chosen, key=lambda f: deg[f])
    kernel_ids, index_ids = [], []
    taken = np.zeros(inc.shape[0], dtype=bool)
    for f in order:
        cand = inc[:, f] & active & ~taken
        ks = np.nonzero(cand)[0]
        for k in ks:
            kernel_ids.append(k)
            index_ids.append(f)
            taken[k] = True
            inc[k, f] = False
    return np.asarray(kernel_ids, np.int32), np.asarray(index_ids, np.int32)


def _merge_cycles(cycles: list[tuple[np.ndarray, np.ndarray]], r: int
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Repair pass (beyond-paper): greedily merge cycle pairs whose kernel
    sets are disjoint and whose union of indices still fits r replicas.
    Merging strictly reduces the cycle count, so PE utilization can only
    improve; C1/C2 are preserved by construction."""
    cycles = [(set(k.tolist()), list(zip(k.tolist(), f.tolist())))
              for k, f in cycles]
    merged = True
    while merged:
        merged = False
        cycles.sort(key=lambda c: len(c[1]))
        for i in range(len(cycles)):
            for j in range(len(cycles) - 1, i, -1):
                ki, pi = cycles[i]
                kj, pj = cycles[j]
                if ki & kj:
                    continue
                union_idx = {f for _, f in pi} | {f for _, f in pj}
                if len(union_idx) > r:
                    continue
                cycles[i] = (ki | kj, pi + pj)
                del cycles[j]
                merged = True
                break
            if merged:
                break
    out = []
    for _, pairs in cycles:
        ks = np.asarray([k for k, _ in pairs], np.int32)
        fs = np.asarray([f for _, f in pairs], np.int32)
        out.append((ks, fs))
    return out


def schedule_exact_cover(index_matrix: np.ndarray, k2: int, r: int,
                         merge: bool = True) -> Schedule:
    """Alg 2: greedy approximate exact cover (+ merge repair pass)."""
    inc = _edges_from_matrix(index_matrix, k2)
    n = inc.shape[0]
    cycles: list[tuple[np.ndarray, np.ndarray]] = []
    deg_tiebreak = n + 1
    while inc.any():
        active = inc.any(axis=1)
        uncovered = active.copy()
        chosen: list[int] = []
        deg = inc.sum(axis=0)
        while len(chosen) < r and uncovered.any():
            cover = inc[uncovered].sum(axis=0)
            for f in chosen:
                cover[f] = 0
            # maximize coverage; tie-break toward low-degree index nodes
            score = cover * deg_tiebreak - deg
            score[cover == 0] = -1
            f_star = int(np.argmax(score))
            if cover[f_star] == 0:
                break
            chosen.append(f_star)
            uncovered &= ~inc[:, f_star]
        ks, fs = _assign_and_delete(inc, active, chosen)
        cycles.append((ks, fs))
    if merge:
        cycles = _merge_cycles(cycles, r)
    return Schedule(n, r, cycles)


def schedule_lowest_index_first(index_matrix: np.ndarray, k2: int, r: int,
                                ) -> Schedule:
    """Baseline [16]: each kernel proposes its lowest remaining index; the
    cycle serves the r lowest distinct proposals."""
    inc = _edges_from_matrix(index_matrix, k2)
    cycles: list[tuple[np.ndarray, np.ndarray]] = []
    while inc.any():
        active = np.nonzero(inc.any(axis=1))[0]
        proposals = np.array([int(np.nonzero(inc[k])[0][0]) for k in active])
        served = np.unique(proposals)[:r]
        mask = np.isin(proposals, served)
        ks = active[mask].astype(np.int32)
        fs = proposals[mask].astype(np.int32)
        inc[ks, fs] = False
        cycles.append((ks, fs))
    return Schedule(inc.shape[0], r, cycles)


def schedule_random(index_matrix: np.ndarray, k2: int, r: int,
                    seed: int = 0) -> Schedule:
    """Baseline: random kernel order, random index pick per kernel; a pick
    is accepted if its index is already in the cycle or a replica is free."""
    rng = np.random.default_rng(seed)
    inc = _edges_from_matrix(index_matrix, k2)
    cycles: list[tuple[np.ndarray, np.ndarray]] = []
    while inc.any():
        active = np.nonzero(inc.any(axis=1))[0]
        rng.shuffle(active)
        in_cycle: set[int] = set()
        kernel_ids, index_ids = [], []
        for k in active:
            opts = np.nonzero(inc[k])[0]
            f = int(rng.choice(opts))
            if f in in_cycle or len(in_cycle) < r:
                in_cycle.add(f)
                kernel_ids.append(k)
                index_ids.append(f)
                inc[k, f] = False
        cycles.append((np.asarray(kernel_ids, np.int32),
                       np.asarray(index_ids, np.int32)))
    return Schedule(inc.shape[0], r, cycles)


SCHEDULERS = {
    "exact_cover": schedule_exact_cover,
    "lowest_index": schedule_lowest_index_first,
    "random": schedule_random,
}


# ---------------------------------------------------------------------------
# Verification / simulation
# ---------------------------------------------------------------------------

def verify_schedule(sched: Schedule, index_matrix: np.ndarray,
                    k2: int) -> None:
    """Check C1, C2 and exact cover (every non-zero served exactly once);
    raises ``PlanValidationError`` on violation."""
    seen = np.zeros((sched.n_kernels, k2), dtype=int)
    for ti, (ks, fs) in enumerate(sched.cycles):
        if len(np.unique(ks)) != len(ks):
            raise PlanValidationError(
                f"C1 violated: duplicate kernel in cycle {ti}",
                site="verify_schedule")
        if len(np.unique(fs)) > sched.r:
            raise PlanValidationError(
                f"C2 violated: cycle {ti} touches {len(np.unique(fs))} "
                f"distinct indices > r={sched.r} replicas",
                site="verify_schedule")
        seen[ks, fs] += 1
    want = _edges_from_matrix(index_matrix, k2).astype(int)
    if not np.array_equal(seen, want):
        raise PlanValidationError(
            "schedule is not an exact cover of the kernels "
            "(some non-zero served zero or multiple times)",
            site="verify_schedule")


def simulate_layer_utilization(indices: np.ndarray, k2: int, r: int,
                               n_par: int, method: str = "exact_cover",
                               channel_sample: int | None = None,
                               seed: int = 0) -> float:
    """Average PE utilization of a layer (Eq 14 numerator/denominator
    aggregated over kernel groups x input channels).

    indices: [c_out, c_in, nnz] per-kernel sorted freq indices.
    The schedule is shared by all P' parallel tiles, so utilization is
    independent of P'.  ``channel_sample`` caps the number of input
    channels simulated (deterministic subsample) — the paper's statistic
    is an average, and per-channel variance is tiny.
    """
    c_out, c_in, _ = indices.shape
    rng = np.random.default_rng(seed)
    chans = np.arange(c_in)
    if channel_sample is not None and channel_sample < c_in:
        chans = np.sort(rng.choice(c_in, channel_sample, replace=False))
    fn = SCHEDULERS[method]
    total_ops = 0
    total_slots = 0
    for m in chans:
        for g0 in range(0, c_out, n_par):
            mat = indices[g0:g0 + n_par, m, :]
            kwargs = {"seed": seed} if method == "random" else {}
            s = fn(mat, k2, r, **kwargs)
            total_ops += s.total_ops
            total_slots += s.n_cycles * mat.shape[0]
    return total_ops / total_slots


# ---------------------------------------------------------------------------
# Fig 6 storage layout: INDEX + VALUE tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScheduleTables:
    """Hardware tables for one (kernel-group, input-channel) schedule.

    index_table: int32 [T, r]    replica read addresses (padded with 0).
    sel:         int32 [T, N']   which replica column feeds PE n.
    valid:       bool  [T, N']   PE n active this cycle.
    values:      complex64 [T, N']  weight fed to PE n this cycle.
    out_index:   int32 [T, N']   frequency index PE n accumulates into
                                 (== index_table[t, sel[t, n]]).
    """

    index_table: np.ndarray
    sel: np.ndarray
    valid: np.ndarray
    values: np.ndarray
    out_index: np.ndarray

    @property
    def n_cycles(self) -> int:
        return self.index_table.shape[0]


def build_tables(sched: Schedule, kernel_values: np.ndarray,
                 index_matrix: np.ndarray) -> ScheduleTables:
    """Compile a schedule into INDEX/VALUE tables (Fig 6).

    kernel_values: complex [N', K^2] dense (zeros at pruned positions).
    """
    n = sched.n_kernels
    t = sched.n_cycles
    r = sched.r
    index_table = np.zeros((t, r), np.int32)
    sel = np.zeros((t, n), np.int32)
    valid = np.zeros((t, n), bool)
    values = np.zeros((t, n), np.complex64)
    out_index = np.zeros((t, n), np.int32)
    for ti, (ks, fs) in enumerate(sched.cycles):
        uniq = np.unique(fs)
        index_table[ti, :len(uniq)] = uniq
        pos = {int(f): i for i, f in enumerate(uniq)}
        for k, f in zip(ks, fs):
            sel[ti, k] = pos[int(f)]
            valid[ti, k] = True
            values[ti, k] = kernel_values[k, f]
            out_index[ti, k] = f
    return ScheduleTables(index_table, sel, valid, values, out_index)


def active_bins_from_tables(tables: "ScheduleTables | list[ScheduleTables]"
                            ) -> np.ndarray:
    """Frequency bins the schedule ever accumulates into.

    Because the schedule is an exact cover (every non-zero served exactly
    once, ``verify_schedule``), this union over valid ``out_index``
    entries equals the union of non-zero bins of the scheduled kernels —
    it is the bin set the fused kernel's active-bin compaction
    (``core.plan`` / ``kernels.fused_spectral_conv``) may restrict the
    spectral GEMM to.
    """
    if isinstance(tables, ScheduleTables):
        tables = [tables]
    bins: set[int] = set()
    for tb in tables:
        bins.update(np.unique(tb.out_index[tb.valid]).tolist())
    return np.asarray(sorted(bins), np.int64)


@dataclasses.dataclass(frozen=True)
class LayerTables:
    """Whole-layer Alg-2 tables, stacked and padded for the FUSED kernel.

    ``build_tables`` emits one ``ScheduleTables`` per (kernel-group,
    input-channel) pair; the fused scheduled datapath
    (``kernels.fused_spectral_conv``, hadamard mode 'scheduled') wants
    them as four rectangular operands it can block over the (n, m) grid
    axes.  Two FPGA planes are folded away relative to Fig 6:

      * ``valid`` — invalid PE lanes carry a zero weight, and a zero
        weight already kills the MAC *and* the scatter contribution;
      * ``out_index`` — by construction ``out_index == index_table[t,
        sel]``, so the kernel recovers each lane's scatter bin with one
        indexed load and it never needs streaming.

    Shapes (GN kernel groups of N' = n_par, Mp >= M channels, T cycles):

      idx  int32 [GN, Mp, T, r]   replica read addresses, in COMPACTED
                                  active-bin coordinates when ``active``
                                  was given (0-padded);
      sel  int32 [GN, Mp, T, N']  replica column feeding PE n;
      vr/vi f32  [GN, Mp, T, N']  complex weight per PE lane, zeroed on
                                  idle lanes and padded cycles/channels.

    ``total_cycles`` sums schedule length over every (group, channel)
    pair — the layer's serial Hadamard latency in PE cycles — and
    ``pe_utilization`` is the exact Eq-14 value over the whole layer
    (not sampled).
    """

    idx: np.ndarray
    sel: np.ndarray
    vr: np.ndarray
    vi: np.ndarray
    total_cycles: int
    pe_utilization: float

    @property
    def n_groups(self) -> int:
        return self.idx.shape[0]

    @property
    def m_pad(self) -> int:
        return self.idx.shape[1]

    @property
    def n_cycles(self) -> int:
        return self.idx.shape[2]

    @property
    def r(self) -> int:
        return self.idx.shape[3]

    @property
    def n_par(self) -> int:
        return self.sel.shape[3]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.idx, self.sel, self.vr, self.vi))


# Channels of one kernel group per pool task of ``compile_layer_tables``.
POOL_BLOCK = 8


def _schedule_block(method: str, indices: np.ndarray, values: np.ndarray,
                    k2: int, r: int) -> list[tuple[ScheduleTables, int, int]]:
    """Schedule and tabulate the channels of one kernel-group block.

    indices [ng, mb, nnz], values [ng, mb, K^2] -> per channel
    (tables, total_ops, n_cycles).  Module-level so a process pool can
    run it."""
    fn = SCHEDULERS[method]
    out = []
    for m in range(indices.shape[1]):
        mat = np.asarray(indices[:, m, :])
        s = fn(mat, k2, r)
        out.append((build_tables(s, np.asarray(values[:, m, :]), mat),
                    s.total_ops, s.n_cycles))
    return out


def compile_layer_tables(indices: np.ndarray, values: np.ndarray,
                         k2: int, r: int, n_par: int, *,
                         method: str = "exact_cover",
                         active: np.ndarray | None = None,
                         m_pad_to: int = 1,
                         pool: Executor | None = None) -> LayerTables:
    """Run Alg 2 over EVERY (kernel-group, input-channel) pair of a layer
    and stack the resulting INDEX/VALUE tables into ``LayerTables``.

    indices: int [N, M, nnz] per-kernel sorted frequency indices
             (``SparseSpectralKernels.indices``);
    values:  complex [N, M, K^2] dense kernel values (zeros at pruned
             positions);
    n_par:   N', the PE-group size == the fused kernel's block_n;
    active:  optional sorted active-bin set — table coordinates are
             remapped to positions within it so the kernel can gather/
             scatter directly against compacted spectral blocks;
    m_pad_to: pad the channel axis to this multiple (the fused kernel's
             block_m) with inert all-zero channels;
    pool:    optional executor (a process pool) that schedules blocks of
             ``POOL_BLOCK`` channels of one group in parallel; the result
             is the same as without it.

    This is the paper's offline schedule-compilation step and runs in
    host numpy exactly once per layer (``core.plan``); padded cycles,
    channels and group remainders all carry zero weights and are inert.
    """
    if method not in SCHEDULERS:
        raise KeyError(method)
    n, m_ch, _ = indices.shape
    indices = np.asarray(indices)
    values = np.asarray(values)
    groups = [(g0, min(g0 + n_par, n)) for g0 in range(0, n, n_par)]
    blocks = [(g0, g1, m0, min(m0 + POOL_BLOCK, m_ch))
              for g0, g1 in groups for m0 in range(0, m_ch, POOL_BLOCK)]
    args = [(method, indices[g0:g1, m0:m1], values[g0:g1, m0:m1], k2, r)
            for g0, g1, m0, m1 in blocks]
    if pool is None:
        done = [_schedule_block(*a) for a in args]
    else:
        done = list(pool.map(_schedule_block, *zip(*args)))
    # (group, channel) order, as the serial loop of the reference visits
    per: list[list[ScheduleTables]] = [[] for _ in groups]
    t_max = 1
    total_ops = 0
    total_slots = 0
    total_cycles = 0
    for (g0, g1, _, _), block in zip(blocks, done):
        for tb, ops, cycles in block:
            total_ops += ops
            total_slots += cycles * (g1 - g0)
            total_cycles += cycles
            t_max = max(t_max, tb.n_cycles)
            per[g0 // n_par].append(tb)

    pos = None
    if active is not None:
        pos = np.zeros(k2, np.int64)
        pos[np.asarray(active)] = np.arange(len(active))
    mp = m_ch + (-m_ch) % m_pad_to
    gn = len(groups)
    idx = np.zeros((gn, mp, t_max, r), np.int32)
    sel = np.zeros((gn, mp, t_max, n_par), np.int32)
    vr = np.zeros((gn, mp, t_max, n_par), np.float32)
    vi = np.zeros((gn, mp, t_max, n_par), np.float32)
    for g, (g0, g1) in enumerate(groups):
        ng = g1 - g0
        for m, tb in enumerate(per[g]):
            t = tb.n_cycles
            it = tb.index_table
            idx[g, m, :t] = pos[it] if pos is not None else it
            sel[g, m, :t, :ng] = tb.sel
            v = np.where(tb.valid, tb.values, 0)
            vr[g, m, :t, :ng] = v.real
            vi[g, m, :t, :ng] = v.imag
    mu = total_ops / max(1, total_slots)
    # the fault-injection corruption sites (no-ops unless a matching fault
    # is installed); here in the caller's process, on the stacked tables,
    # once per call: a fault installed in the parent is invisible to the
    # pool's workers
    idx = res.fault_corrupt("oob_index", idx)
    vr = res.fault_corrupt("corrupt_value", vr)
    return LayerTables(idx, sel, vr, vi, total_cycles, mu)


def execute_tables(tables: ScheduleTables, x_tile: np.ndarray) -> np.ndarray:
    """Replay the INDEX/VALUE tables against one spectral input tile.

    x_tile: complex [K^2] (single channel).  Returns [N', K^2] partial
    products — must equal ``kernel_values * x_tile`` (masked dense).
    This mirrors the RTL datapath: read replicas at INDEX, route through
    sel, multiply VALUE, accumulate at out_index.
    """
    t, n = tables.sel.shape
    out = np.zeros((n, x_tile.shape[0]), np.complex64)
    for ti in range(t):
        replicas = x_tile[tables.index_table[ti]]          # r reads
        routed = replicas[tables.sel[ti]]                  # route to PEs
        prod = np.where(tables.valid[ti], tables.values[ti] * routed, 0)
        np.add.at(out, (np.arange(n), tables.out_index[ti]), prod)
    return out
