"""``torch_bench.py``'s chained timing (``bench.py``'s ``chained_timing``
and its k dependent calls) on the CPU, where ``timed(k)`` is a host loop of
k calls: (a) the estimator gives ``bench.py``'s ``dt`` and fields on the
same scripted times, the noise-bound case included; (b) each key's chained
runner, after k calls, gives what eager calls give, bit for bit (eps is 0
on finite data: a stateless key's every call equals one eager call, a
state-carried key's k-th call equals k eager solves); (c) K1's scalar
carries, now made on the device from Python numbers, give the bits that
tensor carries give.  The capture of these calls as CUDA graphs needs a
card: ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (numpy only at its top)
import torch_bench as tb  # noqa: E402
from meteor_scatter_tpu_torch.apps.frontend import synth_wideband_iq  # noqa: E402
from meteor_scatter_tpu_torch.models import streaming as st  # noqa: E402
from meteor_scatter_tpu_torch.ops import fir  # noqa: E402
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak  # noqa: E402

CPU = torch.device("cpu")
ONCE = tb.Timing(reps=1, warmup=0)
K = 3  # chained calls each runner is held over

# seconds of timed(1) x 3 then timed(k) x 3: a chain that resolves, and one
# whose tk does not exceed t1 (bench.py then reports tk / k, flagged)
SCRIPTS = {
    "resolved": [0.0101, 0.0100, 0.0102, 2.0100, 2.0200, 2.0150],
    "noise_bound": [0.05, 0.04, 0.06, 0.03, 0.035, 0.04],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("prefix", [None, "multi8"])
def test_chained_timing_is_bench_py(script, prefix):
    got = {}
    for side, estimator in (("port", tb.chained_timing), ("jax", bench.chained_timing)):
        times, asked = iter(SCRIPTS[script]), []

        def timed(k):
            asked.append(k)
            return next(times)

        got[side] = (*estimator(timed, 201, prefix=prefix), asked)
    assert got["port"] == got["jax"]
    dt, diag, asked = got["port"]
    p = f"{prefix}_" if prefix else ""
    assert asked == [1] * 3 + [201] * 3 and diag[f"{p}chain_k"] == 201
    assert (diag.get(f"{p}noise_bound") is True) == (script == "noise_bound")
    assert dt == (0.03 / 201 if script == "noise_bound" else (2.0100 - 0.0100) / 200)


# each key's pipeline at a small size, its chain 2 calls long
PIPELINES = {
    None: lambda: tb.batch_pipeline(tb.synth_audio(60.0, seed=2), CPU, ONCE, chain_k=2),
    "multi8": lambda: tb.multi_channel_pipeline(2, 30.0, CPU, ONCE, chain_k=2),
    "stations64": lambda: tb.stations_pipeline(2, 60.0, CPU, ONCE, chain_k=2),
    "channelizer": lambda: tb.frontend_pipeline(1.0, 8, CPU, ONCE, chain_k=2),
    "frontend_iq": lambda: tb.frontend_iq_pipeline(2.0, 8, CPU, ONCE, chain_k=2),
}


@pytest.fixture
def chain_of(monkeypatch):
    """Runs a key's pipeline and returns its artifact fields and the
    :class:`torch_bench.Chain` it timed."""
    seen = {}
    real = tb.chained

    def spy(chain, device, k, samples, prefix=None, *rest, **kw):
        seen[prefix] = chain
        return real(chain, device, k, samples, prefix, *rest, **kw)

    monkeypatch.setattr(tb, "chained", spy)

    def run(prefix):
        fields = PIPELINES[prefix]()
        return fields, seen[prefix]

    return run


def chained_calls(chain) -> list:
    """K dependent calls from the starting carry, each call's outputs
    copied (a state-carried chain overwrites its carry)."""
    chain.start()
    return [tuple(t.clone() for t in chain.step()) for _ in range(K)]


def assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert tb.bits_equal(a, b), i


@pytest.mark.parametrize("prefix", [None, "multi8", "channelizer"])
def test_stateless_chain_equals_one_eager_call(chain_of, prefix):
    fields, chain = chain_of(prefix)
    p = f"{prefix}_" if prefix else ""
    assert fields[f"{p}chain_equals_eager"] is True and fields[f"{p}chain_k"] == 2
    assert len(fields[f"{p}t1_ms"]) == len(fields[f"{p}tk_ms"]) == 3
    assert fields[f"{p}chained_ms"] > 0 and fields[f"{p}chained_samples_per_sec"] > 0
    want = chain.eager()
    for got in chained_calls(chain):
        assert_outputs_equal(got, want)


def stations_solves(n_stations: int, seconds: float):
    """The stations pipeline's eager solves, state carried: its inputs
    remade from the fixture's seed."""
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    x_np, _ = tb.stations_fixture(n_stations, seconds)
    x = torch.from_numpy(x_np.reshape(n_stations, -1, 800))
    state = st.stream_init_batch(scfg, n_stations, device=CPU)
    for _ in range(K):
        on, pm, _ = st.stream_front_headless(cfg, x, tb.STATIONS_FS)
        solve = st.stream_scan_fused_batch(scfg, state, on, pm)
        state = solve[0]
        yield tb.solve_outputs(solve)


def frontend_iq_solves(seconds: float, n_stations: int):
    """The I/Q pipeline's eager solves, state carried: its capture remade
    from the fixture's seed and framed on the host, as the pipeline's."""
    fs, tone = 2_000_000, tb.STATIONS_TONE_HZ
    freqs = tb.iq_station_freqs(n_stations)
    x_re, x_im, _ = synth_wideband_iq(fs, seconds, freqs, seed=3)
    plan, tables = fir.channel_bank_plan(x_re.size, fs, np.asarray([f - tone for f in freqs]),
                                         bandwidth=1500.0, decim=fs // tb.STATIONS_FS,
                                         numtaps=2001, device=CPU)
    f = torch.from_numpy(fir.frame_capture_host(np.stack([x_re, x_im]), plan))
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    state = st.stream_init_batch(scfg, n_stations, device=CPU)
    for _ in range(K):
        on, pm, _ = st.stream_front_headless(cfg, fir.channelize_iq_frames(f, tables, plan)[0],
                                             tb.STATIONS_FS)
        solve = st.stream_scan_fused_batch(scfg, state, on, pm)
        state = solve[0]
        yield tb.solve_outputs(solve)


@pytest.mark.parametrize("prefix, eager", [("stations64", lambda: stations_solves(2, 60.0)),
                                           ("frontend_iq", lambda: frontend_iq_solves(2.0, 8))])
def test_state_carried_chain_equals_eager_solves(chain_of, prefix, eager):
    fields, chain = chain_of(prefix)
    assert fields[f"{prefix}_chain_equals_eager"] is True and fields[f"{prefix}_chain_k"] == 2
    calls = chained_calls(chain)
    assert_outputs_equal(calls[0], chain.eager())
    for got, want in zip(calls, eager()):
        assert_outputs_equal(got, want)
    # the carry moved on: the k-th call's block counter is k chunks on
    assert not torch.equal(calls[0][1], calls[-1][1])


def test_k1_carries_from_numbers_equal_tensor_carries():
    """``adaptive_solver_fused_chunk`` takes its carries as Python numbers
    (made on the device by fills) or as scalar tensors (cast): the same
    bits either way, on a haloed chunk with a standing freeze."""
    rng = np.random.default_rng(4)
    d = (rng.standard_normal(3000) * 3.0).astype(np.float32)
    d[1200:1205] += 30.0
    d = torch.from_numpy(d)
    params = (600, 4.0, 600, 15, 100, 50)
    numbers = ak.adaptive_solver_fused_chunk(d, 10_000, 10_020, 3.5, 2.25, *params)
    tensors = ak.adaptive_solver_fused_chunk(
        d, torch.tensor(10_000), torch.tensor(10_020, dtype=torch.int64),
        torch.tensor(3.5, dtype=torch.float64), torch.tensor(2.25), *params)
    assert_outputs_equal(numbers, tensors)
    assert bool(numbers[1].any())


@pytest.mark.parametrize("drift", [0.0, 1.0])
def test_chained_fields_gate_and_profile(tmp_path, drift):
    """``chained`` on a toy chain: bench.py's fields, the rate from the
    estimate, the gate true only when a call equals the eager one, and with
    ``--profile``'s directory a summary of profiled calls under
    ``{prefix}_chained``."""
    carry = torch.zeros(4)

    def step():
        carry.add_(1.0)
        return (carry * 0.0 + drift,)

    chain = tb.Chain(step, carry.zero_, lambda: (torch.zeros(4),))
    got = tb.chained(chain, CPU, 3, 1000, "x", tb.Timing(profile_dir=str(tmp_path)))
    assert got["x_chain_k"] == 3 and len(got["x_t1_ms"]) == len(got["x_tk_ms"]) == 3
    assert got["x_chained_samples_per_sec"] == pytest.approx(1000 / (got["x_chained_ms"] / 1e3))
    assert got["x_chain_equals_eager"] is (drift == 0.0)
    assert got["x_chained_profiled_calls"] == tb.PROFILED_CALLS
    assert (tmp_path / "x_chained" / "trace.json").exists()
