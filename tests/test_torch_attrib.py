"""The port's device-time attribution (``bigdl_tpu_torch/obs/attrib.py``
over ``utils/kineto.py``) against the JAX package's (``bigdl_tpu/obs/
attrib.py`` over ``utils/xplane.py``): the same labels classify the
same, the same ops and durations written as a Kineto trace and as an
XSpace attribute to equal compact dicts, and render, publish and the
table formatter give equal text and gauges. CUDA kernel names place by
the port's rules."""

import json

import pytest

from bigdl_tpu.obs import attrib as jattrib
from bigdl_tpu.obs.metrics import MetricsRegistry as JRegistry
from bigdl_tpu.utils import table as jtable
from bigdl_tpu.utils import xplane
from bigdl_tpu_torch.obs import attrib
from bigdl_tpu_torch.obs.metrics import MetricsRegistry
from bigdl_tpu_torch.utils import kineto, table
from test_roofline import _xspace

# the JAX tests' mixed profile (tests/test_attrib.py): one op a category
# family, durations in picoseconds
MIXED = [
    (1, "fusion.12", 5_000_000_000),
    (2, "convolution.3", 2_000_000_000),
    (3, "all-reduce-start.1", 800_000_000),
    (4, "reduce-scatter.2", 200_000_000),
    (5, "infeed.2", 500_000_000),
    (6, "dot.7", 250_000_000),
    (7, "jit_step/batch_norm_stats", 100_000_000),
    (8, "mystery_op.1", 50_000_000),
]

JAX_LABELS = [name for _, name, _ in MIXED] + [
    "convolution.4", "conv_general_dilated", "convert_element_type.9",
    "dot.3", "dot_general", "fusion.128", "loop_add_fusion.2", "infeed.1",
    "outfeed.1", "jit_train_step/batch_norm_training", "layer_norm.2",
    "flash_fwd_kernel", "softmax.1", "all-gather.7", "totally-unknown-op",
    "reduce-scatter.1", "all-to-all.1", "collective-permute-start.4",
    "psum", "reduce.5", "gather.3", "scatter.1", "copy.2", "transpose.1"]

# CUDA kernel names (Kineto's spelling) and the category each belongs to
CUDA_NAMES = {
    "void flash_fwd_sm90<128, false>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, FwdParams)": "attention",
    "void flash_dq_bf16<128>(BwdParams)": "attention",
    "void flash_dkv_bf16<128>(BwdParams)": "attention",
    "void flash_fwd_f32<64>(FwdParams)": "attention",
    "void bn_coop_kernel<(Mode)2, __nv_bfloat16, 8, true>(CoopArgs)":
        "bn_norm",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<float, float, false>(int, float, float const*)": "bn_norm",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_"
    "kernel__5x_cudnn": "conv",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        "conv",
    "sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        "conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
    "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>": "conv",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": "matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
        "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_128x64_"
    "64x4_tn_align8>(Params)": "matmul",
    "ampere_sgemm_128x64_nn": "matmul",
    "void gemv2T_kernel_val<int, int, float, float, float, 128, 16>":
        "matmul",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
    "<4096ul>)": "collective",
    "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "collective",
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)":
        "collective",
    "Memcpy HtoD (Pageable -> Device)": "infeed",
    "Memcpy DtoH (Device -> Pinned)": "infeed",
    "Memcpy DtoD (Device -> Device)": "elementwise",
    "Memset (Device)": "elementwise",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, "
    "float, 4, 4> >": "elementwise",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
    "at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 4, "
    "64, 64>": "elementwise",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, "
    "float, float, at::native::(anonymous namespace)::"
    "LogSoftMaxForwardEpilogue>(float*, float const*, int)": "elementwise",
    "void (anonymous namespace)::indexing_backward_kernel<float, 4>(long "
    "const*, long const*, float const*, float*, long, long, long, long, "
    "bool)": "elementwise",
    "void (anonymous namespace)::flash_fwd_sm90<128, false>(hopper::Maps, "
    "(anonymous namespace)::Params, int)": "attention",
    "void (anonymous namespace)::bn_coop_kernel<3, __nv_bfloat16, 8, true>"
    "((anonymous namespace)::CoopArgs)": "bn_norm",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_"
    "kernel__5x_cudnn": "conv",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
    "optimized_bf16_256x64_32x4_nhwc_align8>(Params)": "conv",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>"
    "(cublasLt::cublasSplitKParams<float>)": "matmul",
    "nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT": "matmul",
    "some_kernel_nobody_named": "host_other",
}


def _write_kineto(path, dev_ops, host_ops=(), device=0):
    """A Kineto trace of ``dev_ops`` ((name, picoseconds)) as kernels on
    one card and ``host_ops`` as cpu_op rows, one after the other."""
    evs, ts = [], 0.0
    for name, ps in dev_ops:
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        evs.append({"ph": "X", "cat": cat, "name": name, "pid": device,
                    "tid": 7, "ts": ts, "dur": ps / 1e6,
                    "args": {"device": device, "stream": 7}})
        ts += ps / 1e6
    for name, ps in host_ops:
        evs.append({"ph": "X", "cat": "cpu_op", "name": name, "pid": 1,
                    "tid": 1, "ts": 0.0, "dur": ps / 1e6})
    evs.append({"ph": "M", "name": "process_name", "pid": 1, "args": {}})
    evs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": 1, "ts": 0.0, "dur": 5.0})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": evs}))
    return str(path)


def _write_xspace(tmp_path, dev_ops, host_ops=()):
    d = tmp_path / "xprof" / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    blobs = [_xspace("/device:TPU:0 (xla)", [
        (i + 1, name, ps, 1) for i, (name, ps) in enumerate(dev_ops)])]
    if host_ops:
        blobs.append(_xspace("/host:CPU", [
            (i + 1, name, ps, 1) for i, (name, ps) in enumerate(host_ops)]))
    (d / "host.xplane.pb").write_bytes(b"".join(blobs))
    return str(tmp_path / "xprof")


def _both(tmp_path, dev_ops, host_ops=(), **kw):
    kt = _write_kineto(tmp_path / "kin" / "trace.json", dev_ops, host_ops)
    xp = _write_xspace(tmp_path, dev_ops, host_ops)
    ours = attrib.attribute(kineto.parse_trace(kt), **kw)
    ref = jattrib.attribute(xplane.parse_xspace(xplane.find_xplane_pb(xp)),
                            **kw)
    return ours, ref


def _close(a, b, rel=1e-9):
    """Equal JSON-like trees, floats to ``rel``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=1e-15)
    else:
        assert a == b


@pytest.mark.parametrize("label", JAX_LABELS)
def test_classify_op_agrees_on_jax_labels(label):
    assert attrib.classify_op(label) == jattrib.classify_op(label)
    assert kineto.collective_kind(label) == xplane.collective_kind(label)


def test_classify_op_places_cuda_kernel_names():
    got = {n: attrib.classify_op(n)[0] for n in CUDA_NAMES}
    assert got == CUDA_NAMES
    kinds = {n: kineto.collective_kind(n) for n in CUDA_NAMES
             if n.startswith("nccl")}
    assert sorted(kinds.values()) == ["all_reduce", "collective_broadcast",
                                      "collective_permute"]
    assert attrib.CATEGORIES == jattrib.CATEGORIES


@pytest.mark.parametrize("flops", [False, True])
def test_attribute_kineto_equals_jax_xspace(tmp_path, flops):
    """The mixed profile, a Kineto trace beside its XSpace twin (host
    rows excluded on both): equal compact dicts, times to rel 1e-9."""
    ops = [(name, ps) for _, name, ps in MIXED]
    kw = dict(steps=2, top_ops=2)
    if flops:
        kw.update(step_flops=1e9, flops_by_kind={"matmul": 2.5e8,
                                                 "conv": 7.5e8},
                  peak_flops=1e12)
    ours, ref = _both(tmp_path, ops, [("python", 9_000_000_000)], **kw)
    _close(attrib.compact(ours), jattrib.compact(ref))
    _close({k: v for k, v in ours.items() if k != "categories"},
           {k: v for k, v in ref.items() if k != "categories"})
    for c in attrib.CATEGORIES:
        _close(ours["categories"][c], ref["categories"][c])
    assert ours["device_planes"] == 1
    assert attrib.render(ours) == jattrib.render(ref)


def test_attribute_host_fallback_matches_jax(tmp_path):
    """A trace with no device event attributes its host operators, as
    the JAX attribution falls back to the planes that carry events."""
    kt = _write_kineto(tmp_path / "k" / "trace.json", [],
                       [("aten::conv2d", 3_000_000), ("aten::mm", 1_000_000),
                        ("Optimizer.step#SGD.step", 500_000)])
    planes = kineto.parse_trace(kt)
    assert [p.name for p in planes] == ["/host:CPU"]
    assert kineto.device_planes(planes) == []
    out = attrib.attribute(planes, steps=1)
    assert out["total_device_s"] == pytest.approx(4.5e-6)
    assert out["categories"]["conv"]["time_s"] == pytest.approx(3e-6)
    assert out["categories"]["matmul"]["time_s"] == pytest.approx(1e-6)
    assert out["categories"]["host_other"]["time_s"] == pytest.approx(5e-7)


def test_kineto_reader_planes_totals_and_find(tmp_path):
    kt = _write_kineto(tmp_path / "w" / "capture_3" / "trace.json",
                       [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 4_000_000),
                        ("Memcpy HtoD (Pageable -> Device)", 1_000_000),
                        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                         2_000_000)], [("aten::add", 7)])
    (tmp_path / "w" / "spans.trace.json").write_text('{"traceEvents": []}')
    (tmp_path / "w" / "memory_report.json").write_text("{}")
    assert kineto.find_trace(str(tmp_path / "w")) == kt
    assert kineto.find_trace(str(tmp_path / "none")) is None
    planes = kineto.parse_trace(kt)
    assert [p.name for p in planes] == ["/device:GPU:0", "/host:CPU"]
    dev = kineto.device_planes(planes)
    tot = kineto.op_totals(dev)
    assert tot["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] == {
        "total_ps": 6_000_000.0, "count": 2}
    assert kineto.collectives(dev) == {
        "all_reduce": {"total_ps": 6_000_000.0, "count": 2}}
    assert kineto.collectives([]) == xplane.collectives([]) == {}
    bad = tmp_path / "bad.json"
    bad.write_text('{"other": 1}')
    with pytest.raises(ValueError):
        kineto.parse_trace(str(bad))


def test_attribute_profile_and_errors(tmp_path):
    kt = _write_kineto(tmp_path / "p" / "trace.json",
                       [("void flash_fwd_sm90<128, false>()", 2_000_000)])
    out = attrib.attribute_profile(str(tmp_path / "p"), steps=1)
    assert out["trace"] == kt
    assert out["categories"]["attention"]["frac"] == 1.0
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit):
        attrib.attribute_profile(str(tmp_path / "empty"))
    with pytest.raises(SystemExit):
        jattrib.attribute_profile(str(tmp_path / "empty"))


def test_publish_sets_the_jax_gauges(tmp_path):
    ops = [(name, ps) for _, name, ps in MIXED]
    kw = dict(steps=2, step_flops=1e9, peak_flops=1e12)
    ours, ref = _both(tmp_path, ops, **kw)
    reg, jreg = MetricsRegistry("bigdl"), JRegistry("bigdl")
    attrib.publish(ours, reg)
    jattrib.publish(ref, jreg)

    def gauges(page):
        return {ln.split()[0]: float(ln.split()[1])
                for ln in page.splitlines()
                if ln.startswith("bigdl_attrib_")}

    g, jg = gauges(reg.render()), gauges(jreg.render())
    assert set(g) == set(jg) and "bigdl_attrib_mfu_device" in g
    for k in g:
        assert g[k] == pytest.approx(jg[k], rel=1e-9, abs=1e-15)


@pytest.mark.parametrize("max_col", [72, 8])
def test_format_table_equals_jax(max_col):
    heads = ["category", "time_s", "top ops"]
    rows = [["matmul", "0.00100", "void flash_fwd_sm90<128, false>()"],
            ["conv", 1.5, ""], ["host_other", 0, None]]
    assert table.format_table(heads, rows, max_col) == \
        jtable.format_table(heads, rows, max_col)
    assert table.format_table(heads, [], max_col) == \
        jtable.format_table(heads, [], max_col)
    t = table.T(1, "a", lr=0.1)
    assert t[1] == 1 and t["lr"] == 0.1 and t.to_list() == [1, "a"]
    assert t.insert(3).remove() == 3 and len(t) == 3
