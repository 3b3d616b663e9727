"""repro_torch sharded spectral inference == repro's, on the same weights.

The port's mesh is a tuple of devices driven from one process; here it is
``(cpu,) * D``, in-process, in the role of the reference's forced 8-device
CPU mesh.  ``forward_spectral_sharded`` is held to the reference's
base-plan forward (``pallas_fused`` in interpret mode, windowed plans: the
reference halo path does not run on this tree's jax) within 1e-5 abs over
the reference's own matrix, (4, channel), (2, spatial), (3, spatial),
(4, auto), and on a small residual DAG; one subprocess forces 8 XLA CPU
devices and runs the reference's own ``forward_spectral_sharded``, held to
the port's forward on the same weights.  Also: the two-level cost and
tuner, the channel shards' tables, the mesh's and the plan's partition
checks.
"""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet18_spectral import SMOKE as JAX_RESNET_SMOKE
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.models import cnn as jcnn
from repro_torch.configs.resnet18_spectral import SMOKE as RESNET_SMOKE
from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.distributed import executor as ex
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.launch.mesh import SpectralMesh, make_spectral_mesh

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ABS_TOL = 1e-5
CPU = torch.device("cpu")


class JTinyCfg:
    """The reference sharded suite's two-layer net: channel sharding
    feasible at D in {2, 4}, spatial at D <= 3 (3 tile rows)."""
    name = "tiny-shard"
    fft_size = 8
    alpha = 4.0
    layers = (jdf.ConvLayer("c1", 4, 8, 16, 16, 3, 1),
              jdf.ConvLayer("c2", 8, 8, 16, 16, 3, 1))
    pool_after = frozenset({"c2"})
    graph = None


class TinyCfg(JTinyCfg):
    layers = tuple(df.ConvLayer(l.name, l.c_in, l.c_out, l.h_in, l.w_in)
                   for l in JTinyCfg.layers)


def tiny_params(seed=0) -> dict:
    """Numpy weights of TinyCfg (FC head on the 8 x 8 x 8 pooled map)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *sh, s=0.1: (s * rng.standard_normal(sh)).astype(np.float32)
    return {"convs": [{"w": f32(l.c_out, l.c_in, 3, 3), "b": f32(l.c_out)}
                      for l in JTinyCfg.layers],
            "fc1": f32(512, 16, s=0.05), "fc2": f32(16, 16, s=0.05),
            "fc3": f32(16, 4, s=0.05)}


def resnet_params(seed=0) -> dict:
    """Numpy weights of the ResNet-18 SMOKE (He-normal convs, small
    biases, FC head on the avg-pooled map)."""
    rng = np.random.default_rng(seed)
    convs = [{"w": (rng.standard_normal((l.c_out, l.c_in, 3, 3))
                    * (2.0 / (9 * l.c_in)) ** 0.5).astype(np.float32),
              "b": (0.05 * rng.standard_normal(l.c_out)).astype(np.float32)}
             for l in RESNET_SMOKE.layers]
    feat = 16 * 4 * 4                   # 16 channels, 4 x 4 after the pools
    f32 = lambda *sh: (0.05 * rng.standard_normal(sh)).astype(np.float32)
    return {"convs": convs, "fc1": f32(feat, 32), "fc2": f32(32, 32),
            "fc3": f32(32, 10)}


def _jax_tree(params):
    if isinstance(params, dict):
        return {k: _jax_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_jax_tree(v) for v in params]
    return jnp.asarray(params)


NETS = {"tiny": (TinyCfg, JTinyCfg, tiny_params, (2, 4, 16, 16)),
        "resnet18": (RESNET_SMOKE, JAX_RESNET_SMOKE, resnet_params,
                     (2, 3, 32, 32))}


@pytest.fixture(scope="module")
def reference():
    """Per net: the numpy weights and input, and the reference's base-plan
    logits (``pallas_fused``, interpret mode, windowed bin plan)."""
    out = {}
    for name, (_, jcfg, make, xshape) in NETS.items():
        params = make()
        x = np.random.default_rng(7).standard_normal(xshape).astype(
            np.float32)
        jparams = _jax_tree(params)
        jbase = jpl.build_network_plan(jparams, jcfg, batch=2,
                                       hadamard="bin", input_mode="windowed")
        ref = np.asarray(jcnn.forward_spectral(
            jparams, jbase, jnp.asarray(x), backend="pallas_fused",
            interpret=True))
        out[name] = (params, x, ref)
    return out


def cpu_mesh(d: int) -> SpectralMesh:
    return make_spectral_mesh(d, devices=[CPU] * d)


@pytest.mark.parametrize("net,d,strategies", [
    ("tiny", 4, ("channel",)), ("tiny", 2, ("spatial",)),
    ("tiny", 3, ("spatial",)), ("tiny", 4, None),
    ("resnet18", 2, ("spatial",)), ("resnet18", 4, None)])
def test_sharded_forward_matches_reference(reference, net, d, strategies):
    """The port's sharded forward on (cpu,) * D against the reference's
    base-plan forward: logits within 1e-5 abs; a forced plan uses the
    strategy it was asked for."""
    cfg = NETS[net][0]
    params, x, ref = reference[net]
    tparams = params_from_numpy(params, "cpu")
    splan = pl.build_sharded_network_plan(tparams, cfg, n_shards=d, batch=2,
                                          strategies=strategies,
                                          device="cpu")
    used = set(splan.strategies.values()) - {"replicate"}
    if strategies is not None:      # 'auto' may replicate every tiny layer
        assert used == set(strategies)
    y = ex.forward_spectral_sharded(tparams, splan, torch.from_numpy(x),
                                    mesh=cpu_mesh(d))
    assert y.shape == ref.shape
    assert float(np.abs(y.numpy() - ref).max()) <= ABS_TOL


@pytest.mark.parametrize("hadamard,input_mode", [
    ("scheduled", "windowed"), ("bin", "halo"), ("scheduled", "halo")])
@pytest.mark.parametrize("d,strategies", [(2, ("spatial",)),
                                          (4, ("channel",))])
def test_sharded_forward_other_modes_match_reference(
        reference, hadamard, input_mode, d, strategies):
    """The scheduled tables and the halo input path under both strategies
    (the band kernels in band mode, the channel shards' sliced tables)
    against the reference's base-plan forward, within 1e-5 abs."""
    params, x, ref = reference["tiny"]
    tparams = params_from_numpy(params, "cpu")
    splan = pl.build_sharded_network_plan(
        tparams, TinyCfg, n_shards=d, batch=2, strategies=strategies,
        hadamard=hadamard, input_mode=input_mode, device="cpu")
    assert set(splan.strategies.values()) == set(strategies)
    y = ex.forward_spectral_sharded(tparams, splan, torch.from_numpy(x),
                                    mesh=cpu_mesh(d))
    assert float(np.abs(y.numpy() - ref).max()) <= ABS_TOL


def test_reference_executor_matches_port(tmp_path):
    """The reference's own forward_spectral_sharded on a forced 8-device
    XLA CPU mesh (windowed plans, (4, channel) and (2, spatial)) against
    the port's on the same weights: logits within 1e-5 abs."""
    params, x = tiny_params(), np.random.default_rng(7).standard_normal(
        (2, 4, 16, 16)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, **{
        f"c{i}_{k}": v for i, c in enumerate(params["convs"])
        for k, v in c.items()}, **{k: params[k]
                                   for k in ("fc1", "fc2", "fc3")})
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax.numpy as jnp, numpy as np
        from repro.core import dataflow as df
        from repro.core import plan as pl
        from repro.distributed.executor import forward_spectral_sharded
        from repro.launch.mesh import make_spectral_mesh

        class Cfg:
            name = "tiny-shard"; fft_size = 8; alpha = 4.0; graph = None
            layers = (df.ConvLayer("c1", 4, 8, 16, 16, 3, 1),
                      df.ConvLayer("c2", 8, 8, 16, 16, 3, 1))
            pool_after = frozenset({{"c2"}})

        z = np.load({str(tmp_path / "in.npz")!r})
        params = {{"convs": [{{"w": jnp.asarray(z[f"c{{i}}_w"]),
                               "b": jnp.asarray(z[f"c{{i}}_b"])}}
                              for i in range(2)]}}
        params.update({{k: jnp.asarray(z[k]) for k in ("fc1", "fc2",
                                                       "fc3")}})
        out = {{}}
        for d, strats in [(4, ("channel",)), (2, ("spatial",))]:
            splan = pl.build_sharded_network_plan(
                params, Cfg, n_shards=d, batch=2, strategies=strats,
                hadamard="bin", input_mode="windowed")
            out[strats[0]] = np.asarray(forward_spectral_sharded(
                params, splan, jnp.asarray(z["x"]),
                mesh=make_spectral_mesh(d), interpret=True))
        np.savez({str(tmp_path / "out.npz")!r}, **out)
        print("REFERENCE_SHARDED_OK")
    """)
    r = subprocess.run([sys.executable, "-c", script],
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REFERENCE_SHARDED_OK" in r.stdout
    got = np.load(tmp_path / "out.npz")
    tparams = params_from_numpy(params, "cpu")
    for d, strategy in [(4, "channel"), (2, "spatial")]:
        splan = pl.build_sharded_network_plan(
            tparams, TinyCfg, n_shards=d, batch=2, strategies=(strategy,),
            device="cpu")
        y = ex.forward_spectral_sharded(tparams, splan, torch.from_numpy(x),
                                        mesh=cpu_mesh(d))
        assert float(np.abs(y.numpy() - got[strategy]).max()) <= ABS_TOL


# ---------------------------------------------------------------------------
# The two-level cost model and tuner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", df.SHARD_STRATEGIES)
@pytest.mark.parametrize("layer", [df.VGG16_LAYERS[1], df.VGG16_LAYERS[8],
                                   df.VGG16_LAYERS[12]],
                         ids=lambda l: l.name)
def test_sharded_cost_is_local_kernel_plus_link(layer, strategy):
    """One device's kernel on the shard-local layer plus the collective's
    bytes at the NVLink figure; None where the strategy is infeasible."""
    d = 4
    c = at.hopper_sharded_flow_cost(layer, 8, 4.0, "output_stationary",
                                    "bin", "halo", n_shards=d,
                                    strategy=strategy, active_bins=16)
    local = df.shard_local_layer(layer, 8, d, strategy)
    if local is None:
        assert c is None
        return
    own = at.hopper_fused_flow_cost(local, 8, 4.0, "output_stationary",
                                    "bin", "halo", active_bins=16)
    ici = df.shard_ici_bytes(layer, d, strategy)
    assert c["predicted_s"] == own["predicted_s"]
    assert c["per_chip_hbm_bytes"] == own["hbm_bytes"]
    assert c["ici_bytes"] == ici
    assert c["sharded_s"] == own["predicted_s"] + ici / \
        at.H100_NVLINK_BYTES_PER_S


@pytest.mark.parametrize("layer", df.VGG16_LAYERS[::3], ids=lambda l: l.name)
def test_sharded_tuner_picks_the_cheapest_strategy(layer):
    """The two-level choice is no slower than each strategy's own best;
    a strategy list of one is honoured where it is feasible."""
    best = at.autotune_layer_sharded(layer, 8, 4.0, n_shards=4,
                                     active_bins=16)
    for strategy in df.SHARD_STRATEGIES:
        one = at.autotune_layer_sharded(layer, 8, 4.0, n_shards=4,
                                        strategies=(strategy,),
                                        active_bins=16)
        feasible = df.shard_local_layer(layer, 8, 4, strategy) is not None
        assert one.strategy == (strategy if feasible else "replicate")
        assert best.sharded_s <= one.sharded_s
    net = at.autotune_network_sharded(n_shards=4, active_bins={
        l.name: 16 for l in df.VGG16_LAYERS})
    assert net[layer.name].strategy == best.strategy


def test_channel_shard_tables_are_the_compiled_slices():
    """A channel shard of a scheduled layer takes the base tables' channel
    slice: equal to compiling the shard's kernels and padding to one T."""
    tparams = params_from_numpy(tiny_params(), "cpu")
    splan = pl.build_sharded_network_plan(
        tparams, TinyCfg, n_shards=4, batch=2, strategies=("channel",),
        hadamard="scheduled", device="cpu")
    slp = splan.layers[1]
    lp = slp.base
    raw = [pl._compile_tables(lp, sh.kernels, 10) for sh in slp.shards]
    for got, want in zip((sh.tables for sh in slp.shards),
                         pl._pad_layer_tables(raw, CPU), strict=True):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Errors: the mesh, the executor's mesh check, the partition invariants
# ---------------------------------------------------------------------------

def test_mesh_needs_distinct_devices_or_named_ones():
    """Without ``devices`` the mesh takes distinct CUDA devices and raises
    when there are too few (there is no silent repeat, and no CPU
    fallback); named devices may repeat and must number n_shards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} CUDA devices"):
        make_spectral_mesh(have + 1)
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_spectral_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="n_shards"):
        make_spectral_mesh(0, devices=[])
    mesh = make_spectral_mesh(3, devices=["cpu"] * 3)
    assert mesh.devices == (CPU,) * 3 and mesh.size == 3


@pytest.fixture(scope="module")
def tiny_splans():
    tparams = params_from_numpy(tiny_params(), "cpu")
    build = lambda d, s, **kw: pl.build_sharded_network_plan(
        tparams, TinyCfg, n_shards=d, batch=2, strategies=(s,),
        device="cpu", **kw)
    return {"spatial": build(2, "spatial"),
            "channel": build(4, "channel", hadamard="scheduled"),
            "replicate": build(2, "replicate")}


def test_executor_refuses_another_mesh(tiny_splans):
    splan = tiny_splans["spatial"]
    x = torch.zeros(2, 4, 16, 16)
    with pytest.raises(ValueError, match="built for 2 shards"):
        ex.forward_spectral_sharded({}, splan, x, mesh=cpu_mesh(3))


@pytest.mark.parametrize("strategy", ["spatial", "channel"])
def test_shard_operands_move_once_per_device(tiny_splans, strategy):
    """A shard plan's operands are copied to another device on the first
    call for that device and the copy is reused by later forwards; on
    the device that holds them the plan itself runs."""
    lp = tiny_splans[strategy].layers[0].shards[0]
    assert ex._on_device(lp, CPU) is lp
    meta = torch.device("meta")
    moved = ex._on_device(lp, meta)
    assert ex._on_device(lp, meta) is moved
    assert moved.wr.device == meta and moved.kernels.values.device == meta
    if moved.tables is not None:
        assert all(t.device == meta for t in moved.tables)


def _band(slp, **geo):
    band = slp.shards[0]
    return dataclasses.replace(slp, shards=(dataclasses.replace(
        band, geo=band.geo._replace(**geo)),))


def _shard(slp, i, **kw):
    shards = list(slp.shards)
    shards[i] = dataclasses.replace(shards[i], **kw)
    return dataclasses.replace(slp, shards=tuple(shards))


BREAKS = {
    "unknown strategy": ("spatial", lambda s: dataclasses.replace(
        s, strategy="diagonal")),
    "replicate carries": ("replicate", lambda s: dataclasses.replace(
        s, shards=(s.base,))),
    "one band plan": ("spatial", lambda s: dataclasses.replace(
        s, shards=s.shards * 2)),
    "pre_halo_h": ("spatial", lambda s: _band(s, pre_halo_h=0)),
    "tile rows": ("spatial", lambda s: _band(s, n_tiles_h=1)),
    "halo rows": ("spatial", lambda s: _band(s, h_in=11)),
    "W axis": ("spatial", lambda s: _band(s, w_pad=24)),
    "every channel": ("spatial", lambda s: dataclasses.replace(
        s, shards=(dataclasses.replace(s.shards[0], layer=dataclasses.replace(
            s.shards[0].layer, c_in=2)),))),
    "4 shard plans": ("channel", lambda s: dataclasses.replace(
        s, shards=s.shards[:3])),
    "not divisible": ("channel", lambda s: dataclasses.replace(
        s, n_shards=3, shards=s.shards[:3])),
    "c_in/D": ("channel", lambda s: _shard(s, 1, layer=dataclasses.replace(
        s.shards[1].layer, c_in=3))),
    "partial sums": ("channel", lambda s: _shard(s, 2, geo=s.shards[2].geo
                                                 ._replace(h_in=15))),
    "defer the epilogue": ("channel", lambda s: _shard(
        s, 0, epilogue=s.base.epilogue)),
    "cycle count": ("channel", lambda s: _shard(s, 3, tables=pl.PlanTables(
        *(t[:, :, :1] for t in s.shards[3].tables)))),
}


@pytest.mark.parametrize("what", sorted(BREAKS))
def test_partition_invariants_raise(tiny_splans, what):
    """Each partition invariant (the reference's validate_layer_partition)
    raises ValueError on a plan broken in that one place; the plans as
    built pass."""
    strategy, brk = BREAKS[what]
    splan = tiny_splans[strategy]
    slp = splan.layers[1]
    pl.validate_sharded_plan(splan)
    with pytest.raises(ValueError, match=what):
        pl.validate_layer_partition(brk(slp))


def test_band_launches_are_counted_only_on_a_card(tiny_splans):
    """On CPU tensors every wrapper runs its plain version: the sharded
    forward counts no launch, band or other."""
    params = params_from_numpy(tiny_params(), "cpu")
    before = (dict(fsc.LAUNCHES), dict(fsc.BAND_LAUNCHES))
    ex.forward_spectral_sharded(params, tiny_splans["spatial"],
                                torch.zeros(2, 4, 16, 16), mesh=cpu_mesh(2))
    assert (fsc.LAUNCHES, fsc.BAND_LAUNCHES) == before
    assert spec.shard_band_rows(tiny_splans["spatial"].base.layers[0].geo,
                                2) == 2


def test_resharded_plan_follows_a_moved_base(tiny_splans):
    """``resharded_layer_plan`` rebuilds a layer's shards around another
    base plan (the ladder's step): the shards take the new base's input
    path, the strategy stays, and the note joins the provenance."""
    splan = tiny_splans["spatial"]
    slp = splan.layers[0]
    moved = pl.with_input_mode(splan.base, "halo").layers[0]
    again = pl.resharded_layer_plan(slp, moved, note="halo")
    assert again.strategy == "spatial" and again.provenance == ("halo",)
    assert again.shards[0].input_mode == "halo"
    pl.validate_layer_partition(again)
