"""The busy-interval union, the kernel kinds and a traced window's
summary, on a hand-made trace."""
import pytest

from portbench import profile


def test_union_merges_overlaps_and_keeps_gaps():
    assert profile._union([(5, 7), (0, 2), (1, 3), (7, 8), (10, 11)]) == [
        [0, 3], [5, 8], [10, 11]]


@pytest.mark.parametrize("name,kind", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "matrix product"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "matrix product"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduction"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, ...)",
     "collective"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc",
     "pooling"),
])
def test_kernel_kinds(name, kind):
    assert profile.kernel_kind(name) == kind


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_summary_of_a_window():
    events = [
        _x(profile.WINDOW, "user_annotation", 0, 100),
        _x("aten::conv2d", "cpu_op", 0, 20),
        _x("portbench.data_wait", "user_annotation", 40, 30),
        _x("cudaStreamSynchronize", "cuda_runtime", 80, 15),
        _x("sm90_xmma_fprop_implicit", "kernel", 10, 30, tid=7, stream=7),
        _x("vectorized_elementwise_kernel", "kernel", 35, 10, tid=7,
           stream=7),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 60, 5, tid=8,
           stream=8),
        _x("reduce_kernel", "kernel", 90, 20, tid=7, stream=7),
    ]
    s = profile.summarize(events, steps=2)
    assert s["window_s"] == pytest.approx(100e-6)
    # busy: [10, 45] + [60, 65] + [90, 100] = 50 us
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["kernels"] == 3
    assert s["by_kind_s"]["convolution"] == pytest.approx(30e-6)
    assert s["by_kind_s"]["reduction"] == pytest.approx(10e-6)
    # the gaps, longest first, each named by the host range open where it
    # begins: [65, 90) and [45, 60) in the data wait, [0, 10) in conv2d
    names = [g[0] for g in s["idle_gaps"]]
    assert names == ["portbench.data_wait", "portbench.data_wait",
                     "aten::conv2d"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx(
        [25e-6, 15e-6, 10e-6])
