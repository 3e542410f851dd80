"""The port's sharded serving against the JAX package (the port's replay
of tests/test_fleet_sharded.py): a mesh-placed scheduler bit-exact on
every bench, sharded and plain schedulers serving the same bits, the
placement guard, cohort bucketing, ``launch_shards``, the fleet's mesh
slices and its load report, and open-loop replays through a sharded
scheduler and a mesh-placed fleet. Where the reference forces 8 host
devices (its subprocess test), the port uses an 8-entry CPU mesh in
process; the loadgen's determinism per seed is held against the
reference in tests/test_torch_fleet.py."""
import numpy as np
import pytest
from test_torch_parity import STAT_KEYS, small_benches, variant_mem

from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.serve import Fleet as JaxFleet
from repro.serve.fleet import _mesh_slices as jax_mesh_slices
from repro_torch.ggpu.engine import GGPUConfig, cohort_rows, launch_shards
from repro_torch.launch.mesh import LaunchMesh
from repro_torch.serve import (Fleet, Request, Scheduler, bursty_arrivals,
                               get_executor, poisson_arrivals, replay)
from repro_torch.serve.fleet import _mesh_slices

CFG = GGPUConfig(n_cus=2)
JCFG = JaxConfig(n_cus=2)
CPU = "cpu"
SMALL = small_benches()
MESH = LaunchMesh([CPU] * 8)


def _check(result, direct):
    dmem, dinfo = direct
    np.testing.assert_array_equal(result.mem, np.asarray(dmem))
    for k in STAT_KEYS:
        assert result.info[k] == dinfo[k], k


# -- bit-exactness through the sharded scheduler ----------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
def test_sharded_scheduler_bit_exact(name):
    """An 8-way mesh-placed scheduler returns the reference's direct
    bits, cycles and stats on every bench — a sharded cohort (four images
    over eight shards, padded to eight rows) and a single launch —
    through a monolithic flush and a budgeted drain."""
    b = SMALL[name]()
    progA = b.gpu_prog
    progB = np.vstack([progA, np.zeros((1, progA.shape[1]), np.int32)])
    mems = [b.gpu_mem] + [variant_mem(b, s) for s in range(1, 5)]
    launches = [(progA, m) for m in mems[:4]] + [(progB, mems[4])]
    direct = [jax_run_kernel(progA, m, b.gpu_items, JCFG) for m in mems]

    sched = Scheduler(CFG, max_batch=4, mesh=MESH)
    assert sched.executor.shards == 8
    assert sched.plan_batch == 4 * 8
    for p, m in launches:
        sched.submit(p, m, b.gpu_items)
    got = {r.info["ticket"]: r for r in sched.flush()}
    assert sorted(got) == list(range(len(launches)))
    for t, d in enumerate(direct):
        _check(got[t], d)
    assert sched.executor.stats.dispatches == 2   # the cohort, the single

    sched2 = Scheduler(CFG, max_batch=2, mesh=MESH)
    for p, m in launches:
        sched2.submit(p, m, b.gpu_items)
    out = []
    while len(sched2) or sched2.inflight_chunks:
        out += sched2.drain(budget=2)
    assert not sched2.quarantined
    got2 = {r.info["ticket"]: r for r in out}
    for t, d in enumerate(direct):
        _check(got2[t], d)


def test_sharded_matches_unsharded_scheduler():
    """Sharded and plain schedulers serve one submission stream to the
    same per-ticket bits; the 8-way one in a single 16-wide dispatch of
    a 16-image stream, as the reference's 8-device subprocess test has
    it."""
    b = SMALL["vec_mul"]()
    mems = [b.gpu_mem] + [variant_mem(b, s) for s in range(1, 7)]
    plain = Scheduler(CFG, max_batch=4, device=CPU)
    shard = Scheduler(CFG, max_batch=4, mesh=MESH)
    for m in mems:
        plain.submit(b.gpu_prog, m, b.gpu_items)
        shard.submit(b.gpu_prog, m, b.gpu_items)
    want = {r.info["ticket"]: r for r in plain.flush()}
    got = {r.info["ticket"]: r for r in shard.flush()}
    assert sorted(want) == sorted(got)
    for t in want:
        _check(got[t], (want[t].mem, want[t].info))

    rng = np.random.default_rng(0)
    v = SMALL["vec_mul"]()
    stream = [rng.integers(-20, 20, v.gpu_mem.shape[0]).astype(np.int32)
              for _ in range(16)]
    sched = Scheduler(CFG, max_batch=2, mesh=MESH)
    assert sched.plan_batch == 16
    for m in stream:
        sched.submit(v.gpu_prog, m, v.gpu_items)
    got = {r.info["ticket"]: r for r in sched.flush()}
    assert sched.executor.stats.dispatches == 1
    for t, m in enumerate(stream):
        _check(got[t], jax_run_kernel(v.gpu_prog, m, v.gpu_items, JCFG))


def test_scheduler_rejects_executor_plus_placement():
    with pytest.raises(ValueError):
        Scheduler(CFG, executor=Scheduler(CFG, device=CPU).executor,
                  mesh=MESH)


def test_mesh_executors_share_state_only_on_one_device():
    """A mesh that repeats one device shares that device's canonical
    executor state (memo, stats); its envelope keys carry the placement,
    so its chunks never alias an unsharded chunk's."""
    plain = get_executor(CFG, device=CPU)
    sharded = get_executor(CFG, mesh=MESH)
    assert sharded is get_executor(CFG, mesh=LaunchMesh([CPU] * 8))
    assert sharded.shards == 8 and plain.shards == 1
    assert sharded.memo is plain.memo and sharded.stats is plain.stats
    b = SMALL["copy"]()
    reqs = [Request(b.gpu_prog, b.gpu_mem, b.gpu_items)] * 3
    assert sharded._envelope("cohort", reqs) != plain._envelope("cohort",
                                                                reqs)
    assert sharded._envelope("cohort", reqs)[1] == cohort_rows(3, 8)


# -- cohort bucketing -------------------------------------------------------

def test_cohort_rows_pow2_buckets():
    """Bucketed cohort sizes: >= B, a multiple of shards, power-of-two per
    shard, and monotone in B."""
    for shards in (1, 2, 8):
        prev = 0
        for B in range(1, 70):
            rows = cohort_rows(B, shards)
            per = rows // shards
            assert rows >= B and rows % shards == 0
            assert per & (per - 1) == 0
            assert rows >= prev
            prev = rows
    assert cohort_rows(1) == 1
    assert cohort_rows(5) == 8
    assert cohort_rows(9, 8) == 16
    assert cohort_rows(17, 8) == 32
    assert len({cohort_rows(B, 8) for B in range(1, 257)}) <= 7


def test_launch_shards_matches_device_count():
    assert launch_shards(None) == 1
    assert launch_shards(MESH) == 8
    assert launch_shards(LaunchMesh([CPU])) == 1


# -- open-loop replay through a sharded scheduler ---------------------------

def test_replay_scheduler_open_loop():
    """Replaying a Poisson trace against an 8-way sharded scheduler
    serves every arrival with positive latency and the reference's bits,
    and the report carries its percentile fields."""
    b = SMALL["copy"]()
    mems = [variant_mem(b, s) for s in range(8)]
    sched = Scheduler(CFG, max_batch=4, mesh=MESH)
    arrivals = poisson_arrivals(2000.0, 8, seed=11)
    res = replay(sched, arrivals,
                 lambda i: Request(b.gpu_prog, mems[i], b.gpu_items))
    assert res.served == 8 and res.quarantined == 0
    lat = res.latencies
    assert lat.shape == (8,) and not np.isnan(lat).any()
    assert np.all(lat > 0)
    rep = res.report()
    assert 0 < rep["p50_ms"] <= rep["p99_ms"]
    assert rep["rate_per_s"] > 0


# -- fleet placement and report ---------------------------------------------

def test_mesh_slices_partition():
    """Contiguous proportional slices, the reference's: cover all entries
    exactly once, in order, with empty slices only when the fleet
    outnumbers the mesh."""
    devs = list(MESH.devices)
    for n in (1, 2, 3, len(devs), len(devs) + 2):
        slices = _mesh_slices(MESH, n)
        assert len(slices) == n
        flat = [d for s in slices for d in s]
        assert flat == devs
        sizes = [len(s) for s in slices]
        nonzero = [s for s in sizes if s]
        assert max(nonzero) - min(nonzero) <= 1
        assert sizes == sorted(sizes, reverse=True)

        class _Mesh:                  # the reference reads np.ravel(devices)
            devices = np.arange(len(devs))
        assert sizes == [len(s) for s in jax_mesh_slices(_Mesh, n)]


def test_fleet_report_utilization_and_queue_depth():
    """A two-config fleet on the 8-entry mesh, sliced 4 + 4: the report's
    invariants hold, routed results equal direct runs, and placement,
    busy and backlog equal the reference fleet's with the same shard
    widths."""
    b = SMALL["fir"]()
    fast = GGPUConfig(n_cus=1, freq_mhz=800.0)
    wide = GGPUConfig(n_cus=8, freq_mhz=500.0)
    fleet = Fleet([("fast", fast), ("wide", wide)], max_batch=4, mesh=MESH)
    assert [d.mesh.size for d in fleet.devices] == [4, 4]
    assert all(d.device.type == "cpu" for d in fleet.devices)
    rep0 = fleet.report()
    assert set(rep0["utilization"]) == {"fast", "wide"}
    assert all(v == 0.0 for v in rep0["utilization"].values())
    assert all(v == 0 for v in rep0["queue_depth"].values())
    assert rep0["shards"] == {"fast": 4, "wide": 4}

    ref = JaxFleet([("fast", JaxConfig(n_cus=1, freq_mhz=800.0)),
                    ("wide", JaxConfig(n_cus=8, freq_mhz=500.0))],
                   max_batch=4)
    for d in ref.devices:
        d.scheduler.executor.shards = 4
    for s in range(6):
        fleet.submit(b.gpu_prog, variant_mem(b, s), b.gpu_items)
        ref.submit(b.gpu_prog, variant_mem(b, s), b.gpu_items)
    rep1 = fleet.report()
    assert sum(rep1["queue_depth"].values()) == 6
    out = fleet.drain()
    ref.drain()
    assert len(out) == 6 and not fleet.quarantined
    rep2 = fleet.report()
    assert all(v == 0 for v in rep2["queue_depth"].values())
    util = rep2["utilization"]
    assert max(util.values()) == 1.0
    assert all(0.0 <= v <= 1.0 for v in util.values())
    assert sum(rep2["placement"].values()) == 6
    want = ref.report()
    for key in ("placement", "busy_us", "eta_us", "utilization",
                "makespan_us", "shards"):
        assert rep2[key] == want[key], key
    jcfg_of = {"fast": JaxConfig(n_cus=1, freq_mhz=800.0),
               "wide": JaxConfig(n_cus=8, freq_mhz=500.0)}
    for r in out:
        i = r.info["ticket"]
        _check(r, jax_run_kernel(b.gpu_prog, variant_mem(b, i), b.gpu_items,
                                 jcfg_of[r.info["device"]]))


def test_fleet_leaves_devices_unplaced_beyond_the_mesh():
    """More simulated devices than mesh entries: the surplus gets an
    empty slice and runs unsharded on the fleet's device."""
    fleet = Fleet([GGPUConfig(n_cus=c) for c in (1, 2, 4)],
                  mesh=LaunchMesh([CPU] * 2), device=CPU)
    assert [d.scheduler.executor.shards for d in fleet.devices] == [1, 1, 1]
    assert [d.mesh for d in fleet.devices] == [None, None, None]
    assert all(d.device.type == "cpu" for d in fleet.devices)


def test_replay_drives_fleet():
    b = SMALL["copy"]()
    mems = [variant_mem(b, s) for s in range(6)]
    fleet = Fleet([("a", CFG), ("b", GGPUConfig(n_cus=4))], max_batch=4,
                  mesh=MESH)
    res = replay(fleet, bursty_arrivals(2, 3, 0.002, seed=5),
                 lambda i: Request(b.gpu_prog, mems[i], b.gpu_items))
    assert res.served == 6 and res.quarantined == 0
    assert res.p99_ms >= res.p50_ms > 0
