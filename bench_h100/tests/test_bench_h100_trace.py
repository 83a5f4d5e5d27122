"""The trace reader on a small hand-made Kineto trace."""

from bench_h100 import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 1000),
    _x("user_annotation", "bench.proc_wav_file", 50, 700),
    _x("cpu_op", "aten::matmul", 90, 120),
    _x("cpu_op", "aten::mm", 100, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 10, correlation=5),
    _x("cuda_driver", "cuLaunchKernel", 152, 3, correlation=6),
    _x("cpu_op", "aten::add", 300, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=7),
    _x("cuda_runtime", "cudaStreamSynchronize", 600, 100),
    _x("kernel", "sm80_xmma_gemm", 300, 100, tid=7, correlation=5),
    _x("kernel", "add_kernel", 350, 100, tid=7, correlation=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 700, 50, tid=7, correlation=9),
    _x("kernel", "outside", 2000, 10, tid=7, correlation=11),
]


def test_busy_idle_and_counts():
    t = trace.Trace(EVENTS)
    assert t.window_s == 1e-3
    assert abs(t.busy_s - 200e-6) < 1e-12  # [300, 450] and [700, 750]
    assert t.launches == 2  # the driver call inside the runtime call counts once
    assert t.host_waits == 1
    assert abs(t.copy_s("HtoD") - 50e-6) < 1e-12
    assert t.count_ranges("bench.proc_wav_file") == 1


def test_kernels_by_launching_operator_and_range():
    t = trace.Trace(EVENTS)
    mm = t.kernels(op_in=("aten::mm",), range_name="bench.proc_wav_file")
    assert [e["name"] for e in mm] == ["sm80_xmma_gemm"]
    assert [e["name"] for e in t.kernels(name_has="add")] == ["add_kernel"]


def test_breakdown_names_idle_gaps_by_host_range():
    b = trace.Trace(EVENTS).breakdown()
    assert b["device_ops"][0][0] in ("sm80_xmma_gemm", "add_kernel")
    gaps = dict(b["idle_gaps"])
    # [0, 300) begins in the window only, [450, 700) in the range's sync
    assert set(gaps) >= {"bench.proc_wav_file"}
    assert abs(sum(gaps.values()) - 800e-6) < 1e-12
