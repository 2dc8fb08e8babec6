"""Parity of the port's trace replay (dram_sim, the replay wrapper and
SimEngine) with the JAX reference, on the CPU.

Replay arithmetic is float32 add, max and select only, so latencies and
totals are compared BITWISE.  Statistics (mean, p99) are compared at
1e-5 relative: the device-stats summation order differs from numpy's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram_sim as jdram
from repro.core import perf_model as jpm
from repro.core import sim_engine as jsim
from repro.core import timing as JT
from repro.kernels.replay import ops as jrops
from repro.kernels.replay import ref as jrref
from repro_torch import convert
from repro_torch.core import dram_sim as tdram
from repro_torch.core import sim_engine as tsim
from repro_torch.core import timing as TT
from repro_torch.kernels.replay import ops as trops
from repro_torch.kernels.replay import ref as trref
from _torch_parity import one_thread as _one_thread  # noqa: F401


N = 160
ROWS = JT.stack_timing([JT.DDR3_1600, JT.ALDRAM_55C_EVAL,
                        JT.DDR3_1600.scaled(0.8, 0.7, 0.6, 0.9),
                        JT.DDR3_1600.scaled(0.6, 0.5, 0.4, 0.7),
                        JT.DDR3_1600.scaled(1.1, 1.0, 1.2, 1.0)])


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def streams():
    """Four JAX-synthesized traces of the workload pool ([T, N]) with
    a ragged padding suffix on two of them."""
    tb = jpm.trace_batch(n=N, seed=3)
    pick = [0, 19, 36, 55]           # mcf, gups, mcf multi-core, s.copy
    f = [np.array(np.asarray(x)[pick]) for x in tb]
    valid = np.ones((4, N), bool)
    valid[1, 121:] = False
    valid[3, 37:] = False
    return f, valid


def _grid(streams, policies):
    (arr, bank, row, wr), valid = streams
    p = len(policies)

    def tp(x):
        return np.repeat(x[:, None], p, 1)

    closed = np.array([pol == "closed" for pol in policies])
    return tp(arr), tp(bank), tp(row), tp(wr), valid, closed


@pytest.mark.parametrize("s_rows", [1, 3, 5])
@pytest.mark.parametrize("policies", [("open",), ("open", "closed")])
def test_replay_grid_bitwise_vs_reference(streams, s_rows, policies):
    a, b, r, w, v, closed = _grid(streams, policies)
    tim = ROWS[:s_rows]
    lj, tj = jrref.replay_grid(*(jnp.asarray(x) for x in (a, b, r, w, v)),
                               jnp.asarray(tim), jnp.asarray(closed))
    args = [torch.tensor(x) for x in (a, b, r, w, v, tim, closed)]
    lt, tt = trops.replay_grid(*args)
    assert lt.shape == (4, len(policies), s_rows, N)
    np.testing.assert_array_equal(_bits(lt.numpy()), _bits(lj))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(tj))
    lr, tr = trref.replay_grid(*args)
    assert torch.equal(lr, lt) and torch.equal(tr, tt)


def test_replay_grid_bitwise_vs_pallas_interpret(streams):
    """The reference's own kernel body (interpret mode), with a lane
    block of 4 that S = 5 does not fill."""
    a, b, r, w, v, closed = _grid(streams, ("open", "closed"))
    lj, tj = jrops.replay_grid(*(jnp.asarray(x) for x in (a, b, r, w, v)),
                               jnp.asarray(ROWS), jnp.asarray(closed),
                               impl="pallas_interpret", bs=4)
    lt, tt = trops.replay_grid(*(torch.tensor(x) for x in
                                 (a, b, r, w, v, ROWS, closed)))
    np.testing.assert_array_equal(_bits(lt.numpy()), _bits(lj))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(tj))


@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("t", [0, 1])
def test_replay_one_and_rows_bitwise(streams, closed, t):
    (arr, bank, row, wr), valid = streams
    one = [jnp.asarray(x[t]) for x in (arr, bank, row, wr, valid)]
    lj1, tj1 = jdram.replay_one(*one, jnp.asarray(ROWS[2]), closed)
    ljr, tjr = jdram.replay_rows(*one, jnp.asarray(ROWS), closed)
    ports = [torch.tensor(x[t]) for x in (arr, bank, row, wr, valid)]
    lt1, tt1 = tdram.replay_one(*ports, torch.tensor(ROWS[2]), closed)
    ltr, ttr = tdram.replay_rows(*ports, torch.tensor(ROWS), closed)
    np.testing.assert_array_equal(_bits(lt1.numpy()), _bits(lj1))
    np.testing.assert_array_equal(_bits(tt1.numpy()), _bits(tj1))
    np.testing.assert_array_equal(_bits(ltr.numpy()), _bits(ljr))
    np.testing.assert_array_equal(_bits(ttr.numpy()), _bits(tjr))
    # one row of the stack replays exactly like the single-row call
    assert torch.equal(ltr[2], lt1) and torch.equal(ttr[2], tt1)


@pytest.mark.parametrize("stats", ["device", "host"])
def test_sim_engine_stats_match_reference(streams, stats):
    (arr, bank, row, wr), valid = streams
    lens = valid.sum(1)
    jt = tuple(jdram.Trace(*(jnp.asarray(f[i, :lens[i]])
                             for f in (arr, bank, row, wr)))
               for i in range(4))
    pols_j = (jdram.OPEN_FCFS, jdram.Policy(page="closed"))
    ref = jsim.SimEngine(stats="host", reorder="host").run(
        jsim.SimSpec(traces=jt, timings=ROWS, policies=pols_j))
    tt = tuple(convert.trace(*(f[i, :lens[i]] for f in (arr, bank, row, wr)),
                             device="cpu") for i in range(4))
    eng = tsim.SimEngine(device="cpu", stats=stats)
    res = eng.run(tsim.SimSpec(
        traces=tt, timings=ROWS, collect=("latencies",),
        policies=(tdram.OPEN_FCFS, tdram.Policy(page="closed"))))
    assert eng.dispatch_count == 1
    np.testing.assert_array_equal(res.valid, ref.valid)
    np.testing.assert_array_equal(_bits(res.latencies), _bits(ref.latencies))
    np.testing.assert_array_equal(_bits(res.total_ns), _bits(ref.total_ns))
    np.testing.assert_allclose(res.mean_latency_ns, ref.mean_latency_ns,
                               rtol=1e-5)
    np.testing.assert_allclose(res.p99_latency_ns, ref.p99_latency_ns,
                               rtol=1e-5)


def test_device_stats_match_host_stats():
    rng = np.random.default_rng(4)
    lat = rng.exponential(40.0, (3, 2, 4, 301)).astype(np.float32)
    valid = np.ones((3, 301), bool)
    valid[0, 17:] = False
    valid[2, 200:] = False
    lat = np.where(valid[:, None, None, :], lat, 0.0).astype(np.float32)
    k = tsim._p99_k(valid)
    assert k == jsim._p99_k(valid)
    mean, p99 = tsim._device_stats(torch.tensor(lat), torch.tensor(valid), k)
    hm, hp = tsim._masked_stats(lat, valid)
    jm, jp = jsim._masked_stats(lat, valid)
    np.testing.assert_array_equal(hm, jm)
    np.testing.assert_array_equal(hp, jp)
    np.testing.assert_allclose(mean.numpy(), hm, rtol=1e-5)
    np.testing.assert_allclose(p99.numpy(), hp, rtol=1e-5)


def test_simulate_shim_matches_engine(streams):
    (arr, bank, row, wr), _ = streams
    tr = convert.trace(arr[0], bank[0], row[0], wr[0], device="cpu")
    out = tdram.simulate(tr, TT.ALDRAM_55C_EVAL, device="cpu")
    lat, total = tdram.replay_one(*tr, torch.ones(N, dtype=torch.bool),
                                  torch.tensor(TT.ALDRAM_55C_EVAL.as_row()),
                                  False)
    np.testing.assert_array_equal(out["latencies"], lat.numpy())
    assert out["total_ns"] == total.item()
    np.testing.assert_allclose(out["mean_latency_ns"], lat.mean().item(),
                               rtol=1e-6)


def test_interior_padding_rejected():
    valid = np.ones((2, 8), bool)
    valid[1, 3] = False
    with pytest.raises(ValueError, match="prefix"):
        tdram.check_prefix_valid(valid)
    z = torch.zeros((2, 1, 8))
    with pytest.raises(ValueError, match="prefix"):
        trops.replay_grid(z, z.int(), z.int(), z.bool(), torch.tensor(valid),
                          torch.tensor(ROWS[:1]), torch.tensor([False]))


class TestSynthesis:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_row_pick_matches_scan_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, nb = 400, 8
        bank = rng.integers(0, nb, n).astype(np.int32)
        new_row = rng.integers(0, 4096, n).astype(np.int32)
        reuse = rng.uniform(size=n) < 0.6
        want = jdram._row_pick_scan(jnp.asarray(bank), jnp.asarray(new_row),
                                    jnp.asarray(reuse), nb)
        got = tdram._row_pick(torch.tensor(bank), torch.tensor(new_row),
                              torch.tensor(reuse), nb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_synth_trace_shape_and_locality(self):
        tr = tdram.synth_trace(torch.Generator().manual_seed(0), 4000,
                               row_hit=0.7, device="cpu")
        assert tr.arrival.dtype == torch.float32
        assert tr.bank.dtype == torch.int32 and tr.row.dtype == torch.int32
        assert bool((tr.arrival[1:] >= tr.arrival[:-1]).all())
        assert 0 <= int(tr.bank.min()) and int(tr.bank.max()) < 8
        # a reuse repeats the bank's previous row: ~row_hit of requests
        prev = {}
        hits = 0
        for b, r in zip(tr.bank.tolist(), tr.row.tolist()):
            hits += prev.get(b) == r
            prev[b] = r
        assert 0.65 < hits / 4000 < 0.75

    def test_trace_batch_pool_layout(self):
        from repro_torch.core import perf_model as tpm
        tb = tpm.trace_batch(n=64, seed=0, device="cpu")
        assert tb.arrival.shape == (70, 64)
        assert tpm._pool_knobs() == jpm._pool_knobs()
        again = tpm.trace_batch(n=64, seed=0, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(tb, again))


class TestNotPorted:
    def test_frfcfs_policy_raises(self):
        """FR-FCFS policies are ported (tests/test_torch_traffic.py); a
        policy with an unknown interleave still raises."""
        p = tdram.Policy(reorder_window=16)
        assert (p.reorder_window, p.reorder_slack_ns, p.ileave_code) == \
            (16, 30.0, 0)
        with pytest.raises(ValueError, match="interleave"):
            tdram.Policy(reorder_window=16, interleave="page")

    @pytest.mark.parametrize("kw", [{"n_ranks": 2},
                                    {"traces": object()},
                                    {"n_channels": 2}])
    def test_unported_sim_axes_raise(self, kw):
        """Declarative trace axes and campaign meshes are ported: an
        unknown trace object raises TypeError; a multi-channel campaign
        runs on a mesh, which refuses host statistics and anything but a
        `CampaignMesh`."""
        from repro_torch.launch.mesh import make_campaign_mesh
        tr = tdram.Trace(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.bool))
        if "traces" in kw:
            with pytest.raises(TypeError, match="traces"):
                tsim.SimSpec(**{"timings": ROWS[:1], **kw})
            return
        spec = tsim.SimSpec(**{"traces": (tr,), "timings": ROWS[:1], **kw})
        assert spec.multi
        mesh = make_campaign_mesh(devices=["cpu"])
        res = tsim.SimEngine(device="cpu", mesh=mesh).run(spec)
        assert res.mean_latency_ns.shape == (1, 1, 1)
        with pytest.raises(ValueError, match="stats"):
            tsim.SimEngine(device="cpu", mesh=mesh, stats="host")
        with pytest.raises(TypeError, match="CampaignMesh"):
            tsim.SimEngine(device="cpu", mesh=object())

    def test_banked_timings_raise(self):
        """Per-bank rows are ported; a bank axis that does not match
        the simulated bank count raises."""
        z = torch.zeros((1, 1, 4))
        with pytest.raises(ValueError, match="banks"):
            trops.replay_grid(z, z.int(), z.int(), z.bool(),
                              torch.ones((1, 4), dtype=torch.bool),
                              torch.zeros((2, 4, 6)), torch.tensor([False]))
