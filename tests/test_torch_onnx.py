"""The port's ONNX reader, writer and executor (taste_spokenlm_tpu_torch/
frontend/onnx_*.py) against the JAX package's (frontend/onnx_*.py).

The reader parses the same bytes to the same graph; OnnxTorchFunction on
the CPU gives what OnnxJaxFunction gives on the op cases of
tests/test_onnx_exec.py and on the two architecture-shaped graphs of
tests/test_onnx_architectures.py (f32 within 1e-5 relative to the largest
entry, integer outputs exact); audit_ops gives the same report; the
processor hooks give what JAX's give.  ONNX's traps are each held to the
ONNX semantics (a numpy statement of them), and to JAX's executor where it
keeps them.  One worker: about 15 s.
"""

import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.frontend import onnx_build as JB
from taste_spokenlm_tpu.frontend import onnx_import as jax_import
from taste_spokenlm_tpu.frontend.onnx_exec import OnnxJaxFunction
from taste_spokenlm_tpu.frontend.onnx_exec import audit_ops as jax_audit
from taste_spokenlm_tpu.frontend.onnx_exec import supported_ops as jax_ops
from taste_spokenlm_tpu_torch.frontend import onnx_build as B
from taste_spokenlm_tpu_torch.frontend import onnx_import
from taste_spokenlm_tpu_torch.frontend.onnx_exec import (OnnxTorchFunction,
                                                         audit_ops,
                                                         supported_ops)

INT64_MAX, INT64_MIN = 2 ** 63 - 1, -2 ** 63


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _outs(x):
    return [_np(o) for o in (x if isinstance(x, list) else [x])]


def run_both(blob, *args):
    """(port outputs, JAX outputs) as lists of numpy arrays."""
    port = OnnxTorchFunction.from_file(blob, device="cpu")(*args)
    ref = OnnxJaxFunction.from_file(blob)(*args)
    return _outs(port), _outs(ref)


def assert_same(got, want, rel=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1e-12) if w.size else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# reader / writer
# ---------------------------------------------------------------------------


def _graph_blob(build):
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    return build.build(
        [build.node("Gemm", ["x", "w"], ["y"], name="g", alpha=2.0, transB=1),
         build.node("Concat", ["y", "y"], ["z"], name="c", axis=-1),
         build.node("Constant", [], ["k"], name="k",
                    value=np.asarray([-1, 2], np.int64)),
         build.node("Cast", ["z"], ["zz"], name="cast", to=7),
         build.node("Pad", ["zz", "k"], ["p"], name="pad", mode="reflect",
                    pads=[0, 1], value=0.5)],
        ["x"], ["p"], {"w": w, "axes": np.asarray([-1, 2], np.int64),
                       "half": np.asarray(0.5, np.float16)})


def test_writer_bytes_and_reader_graph_match_jax():
    blob = _graph_blob(B)
    assert blob == _graph_blob(JB)
    got, want = onnx_import.load_onnx(blob), jax_import.load_onnx(blob)
    assert [(n.op_type, n.name, n.inputs, n.outputs) for n in got.nodes] == \
        [(n.op_type, n.name, n.inputs, n.outputs) for n in want.nodes]
    for a, b in zip(got.nodes, want.nodes):
        assert a.attributes.keys() == b.attributes.keys()
        for k in a.attributes:
            x, y = a.attributes[k], b.attributes[k]
            if isinstance(x, tuple):
                np.testing.assert_array_equal(x[1], y[1])
            else:
                assert x == y, (k, x, y)
    assert got.initializers.keys() == want.initializers.keys()
    for k, v in got.initializers.items():
        assert v.dtype == want.initializers[k].dtype
        np.testing.assert_array_equal(v, want.initializers[k])
    assert (got.inputs, got.outputs) == (want.inputs, want.outputs)
    assert got.nodes[0].attributes["alpha"] == pytest.approx(2.0)
    assert got.nodes[1].attributes["axis"] == -1


def test_supported_ops_match_jax():
    assert supported_ops() == jax_ops()
    assert len(supported_ops()) == 83


# ---------------------------------------------------------------------------
# the op cases of tests/test_onnx_exec.py
# ---------------------------------------------------------------------------


def _cnn_case():
    r = np.random.RandomState(0)
    nodes = [
        B.node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[5],
               strides=[2], pads=[2, 2]),
        B.node("BatchNormalization",
               ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["n1"], epsilon=1e-5),
        B.node("Relu", ["n1"], ["r1"]),
        B.node("Conv", ["r1", "w2", "b2"], ["c2"], kernel_shape=[3],
               pads=[2, 2], dilations=[2], group=2),
        B.node("AveragePool", ["c2"], ["p1"], kernel_shape=[2], strides=[2]),
        B.node("GlobalAveragePool", ["p1"], ["g1"]),
        B.node("Squeeze", ["g1"], ["s1"], axes=[2]),
        B.node("Gemm", ["s1", "fw", "fb"], ["y"], transB=1),
    ]
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    init = {"w1": f(8, 4, 5), "b1": f(8), "bn_s": f(8), "bn_b": f(8),
            "bn_m": f(8), "bn_v": r.uniform(0.5, 2, 8).astype(np.float32),
            "w2": f(8, 4, 3), "b2": f(8), "fw": f(6, 8), "fb": f(6)}
    return B.build(nodes, ["x"], ["y"], init), (f(2, 4, 32),)


def _conv2d_case():
    r = np.random.RandomState(1)
    nodes = [
        B.node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[3, 3],
               strides=[2, 1], pads=[1, 0, 1, 0]),
        B.node("MaxPool", ["c"], ["y"], kernel_shape=[2, 2], strides=[2, 2]),
    ]
    init = {"w": r.randn(5, 3, 3, 3).astype(np.float32),
            "b": r.randn(5).astype(np.float32)}
    return (B.build(nodes, ["x"], ["y"], init),
            (r.randn(2, 3, 12, 9).astype(np.float32),))


def _conv_transpose_case():
    r = np.random.RandomState(2)
    nodes = [B.node("ConvTranspose", ["x", "w", "b"], ["y"],
                    kernel_shape=[4], strides=[2], pads=[1, 1])]
    init = {"w": r.randn(6, 4, 4).astype(np.float32),
            "b": r.randn(4).astype(np.float32)}
    return (B.build(nodes, ["x"], ["y"], init),
            (r.randn(2, 6, 10).astype(np.float32),))


def _attention_case():
    r = np.random.RandomState(3)
    b, t, d, h = 2, 7, 16, 4

    def head_split(src, dst):
        return [
            B.node("Shape", [src], [f"{dst}_shape"]),
            B.node("Gather", [f"{dst}_shape", "zero"], [f"{dst}_b"], axis=0),
            B.node("Gather", [f"{dst}_shape", "one"], [f"{dst}_t"], axis=0),
            B.node("Unsqueeze", [f"{dst}_b"], [f"{dst}_b1"], axes=[0]),
            B.node("Unsqueeze", [f"{dst}_t"], [f"{dst}_t1"], axes=[0]),
            B.node("Concat", [f"{dst}_b1", f"{dst}_t1", "hd"],
                   [f"{dst}_tgt"], axis=0),
            B.node("Reshape", [src, f"{dst}_tgt"], [f"{dst}_4d"]),
            B.node("Transpose", [f"{dst}_4d"], [dst], perm=[0, 2, 1, 3]),
        ]

    nodes = [
        B.node("LayerNormalization", ["x", "g", "bias"], ["xn"],
               axis=-1, epsilon=1e-5),
        B.node("MatMul", ["xn", "wq"], ["q2"]),
        B.node("MatMul", ["xn", "wk"], ["k2"]),
        B.node("MatMul", ["xn", "wv"], ["v2"]),
        *head_split("q2", "q"), *head_split("k2", "k"), *head_split("v2", "v"),
        B.node("Transpose", ["k"], ["kT"], perm=[0, 1, 3, 2]),
        B.node("MatMul", ["q", "kT"], ["scores"]),
        B.node("Div", ["scores", "scale"], ["scaled"]),
        B.node("Softmax", ["scaled"], ["attn"], axis=-1),
        B.node("MatMul", ["attn", "v"], ["ctx"]),
        B.node("Transpose", ["ctx"], ["ctxT"], perm=[0, 2, 1, 3]),
        B.node("Shape", ["x"], ["xshape"]),
        B.node("Reshape", ["ctxT", "xshape"], ["merged"]),
        B.node("MatMul", ["merged", "wo"], ["y"]),
    ]
    init = {"g": r.randn(d).astype(np.float32),
            "bias": r.randn(d).astype(np.float32),
            **{k: (0.2 * r.randn(d, d)).astype(np.float32)
               for k in ("wq", "wk", "wv", "wo")},
            "zero": np.asarray(0, np.int64), "one": np.asarray(1, np.int64),
            "hd": np.asarray([h, d // h], np.int64),
            "scale": np.asarray((d // h) ** 0.5, np.float32)}
    return (B.build(nodes, ["x"], ["y"], init),
            (r.randn(b, t, d).astype(np.float32),))


def _misc_case():
    nodes = [
        B.node("Slice", ["x", "st", "en", "ax", "sp"], ["s"]),
        B.node("Pad", ["s", "pads"], ["p"]),
        B.node("Split", ["p"], ["a", "b"], axis=2, num_outputs=2),
        B.node("ReduceMean", ["a"], ["m"], axes=[1], keepdims=0),
        B.node("Expand", ["m", "eshape"], ["e"]),
        B.node("Where", ["cond", "e", "b0"], ["y"]),
        B.node("ReduceSum", ["b"], ["bsum"], axes=[0, 1, 2], keepdims=0),
    ]
    init = {
        "st": np.asarray([1], np.int64), "en": np.asarray([100], np.int64),
        "ax": np.asarray([2], np.int64), "sp": np.asarray([2], np.int64),
        "pads": np.asarray([0, 0, 0, 0, 0, 2], np.int64),
        "eshape": np.asarray([2, 2, 2], np.int64),
        "cond": np.asarray(True), "b0": np.zeros((2, 2, 2), np.float32),
    }
    return (B.build(nodes, ["x"], ["y", "bsum"], init),
            (np.arange(24, dtype=np.float32).reshape(2, 3, 4),))


def _argmax_topk_cast_case():
    nodes = [
        B.node("ArgMax", ["x"], ["am"], axis=-1, keepdims=0),
        B.node("Cast", ["am"], ["amf"], to=1),
        B.node("TopK", ["x", "k"], ["tv", "ti"], axis=-1),
        B.node("Cast", ["ti"], ["ti32"], to=6),
    ]
    return (B.build(nodes, ["x"], ["amf", "tv", "ti32"],
                    {"k": np.asarray([2], np.int64)}),
            (np.asarray([[0.1, 2.0, -1.0, 0.5]], np.float32),))


def _gemm_erf_case():
    r = np.random.RandomState(0)
    nodes = [B.node("Gemm", ["x", "w"], ["h"], transB=1),
             B.node("Erf", ["h"], ["y"])]
    return (B.build(nodes, ["x"], ["y"],
                    {"w": r.randn(5, 3).astype(np.float32)}),
            (np.random.RandomState(1).randn(4, 3).astype(np.float32),))


CASES = {"cnn": _cnn_case, "conv2d_maxpool": _conv2d_case,
         "conv_transpose": _conv_transpose_case, "attention": _attention_case,
         "misc_tensor_ops": _misc_case, "argmax_topk_cast": _argmax_topk_cast_case,
         "gemm_erf": _gemm_erf_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_cases_match_jax(case):
    blob, args = CASES[case]()
    got, want = run_both(blob, *args)
    assert_same(got, want)


def test_unsupported_op_raises():
    bad = OnnxTorchFunction.from_file(
        B.build([B.node("NonsenseOp", ["x"], ["y"])], ["x"], ["y"]),
        device="cpu")
    with pytest.raises(NotImplementedError, match="NonsenseOp"):
        bad(np.zeros((1,), np.float32))


# ---------------------------------------------------------------------------
# the architecture-shaped graphs of tests/test_onnx_architectures.py
# ---------------------------------------------------------------------------


def _bn(prefix, c, r):
    return {f"{prefix}_scale": r.randn(c).astype(np.float32),
            f"{prefix}_bias": r.randn(c).astype(np.float32),
            f"{prefix}_mean": r.randn(c).astype(np.float32),
            f"{prefix}_var": r.uniform(0.5, 2.0, c).astype(np.float32)}


def campplus_shaped():
    """tests/test_onnx_architectures.py:46's CAM++-shaped graph."""
    r = np.random.RandomState(0)
    c0, c, g, e, t = 8, 12, 6, 16, 40
    x = r.randn(1, c0, t).astype(np.float32)
    f = lambda s, *shape: (r.randn(*shape) * s).astype(np.float32)  # noqa
    inits = {"w_stem": f(0.3, c, c0, 5), "b_stem": f(0.1, c)}
    inits.update(_bn("bn1", c, r))
    inits.update(w_d1=f(0.3, g, c, 3), b_d1=f(0.1, g))
    inits.update(_bn("bn2", c + g, r))
    inits.update(w_d2=f(0.3, g, c + g, 3), b_d2=f(0.1, g))
    cin = c + 2 * g
    inits.update(w_cam=f(0.2, cin, cin), b_cam=f(0.1, cin),
                 w_emb=f(0.2, 2 * cin, e), b_emb=f(0.1, e),
                 u_axes=np.asarray([2], np.int64))
    nodes = [
        B.node("Conv", ["x", "w_stem", "b_stem"], ["h0"], kernel_shape=[5],
               strides=[1], pads=[2, 2]),
        B.node("BatchNormalization", ["h0", "bn1_scale", "bn1_bias",
                                      "bn1_mean", "bn1_var"], ["n1"],
               epsilon=1e-5),
        B.node("Relu", ["n1"], ["r1"]),
        B.node("Conv", ["r1", "w_d1", "b_d1"], ["d1"], kernel_shape=[3],
               pads=[1, 1]),
        B.node("Concat", ["h0", "d1"], ["cat1"], axis=1),
        B.node("BatchNormalization", ["cat1", "bn2_scale", "bn2_bias",
                                      "bn2_mean", "bn2_var"], ["n2"],
               epsilon=1e-5),
        B.node("Relu", ["n2"], ["r2"]),
        B.node("Conv", ["r2", "w_d2", "b_d2"], ["d2"], kernel_shape=[3],
               pads=[1, 1], dilations=[1]),
        B.node("Concat", ["cat1", "d2"], ["feat"], axis=1),
        B.node("ReduceMean", ["feat"], ["ctx"], axes=[2], keepdims=0),
        B.node("Gemm", ["ctx", "w_cam", "b_cam"], ["cam_lin"]),
        B.node("Sigmoid", ["cam_lin"], ["gate"]),
        B.node("Unsqueeze", ["gate", "u_axes"], ["gate3"]),
        B.node("Mul", ["feat", "gate3"], ["gated"]),
        B.node("ReduceMean", ["gated"], ["mu"], axes=[2], keepdims=1),
        B.node("Sub", ["gated", "mu"], ["cent"]),
        B.node("Mul", ["cent", "cent"], ["sq"]),
        B.node("ReduceMean", ["sq"], ["var"], axes=[2], keepdims=0),
        B.node("Sqrt", ["var"], ["std"]),
        B.node("ReduceMean", ["gated"], ["mu2"], axes=[2], keepdims=0),
        B.node("Concat", ["mu2", "std"], ["stats"], axis=1),
        B.node("Gemm", ["stats", "w_emb", "b_emb"], ["emb"]),
    ]
    return B.build(nodes, ["x"], ["emb"], inits), x


def s3_shaped():
    """tests/test_onnx_architectures.py:146's S3-tokenizer-shaped graph."""
    r = np.random.RandomState(1)
    m, d, t, h, k = 10, 16, 24, 2, 32
    x = r.randn(1, m, t).astype(np.float32)
    f = lambda s, *shape: (r.randn(*shape) * s).astype(np.float32)  # noqa

    def gelu(src, dst, tag):
        return [
            B.node("Div", [src, f"{tag}_sqrt2"], [f"{tag}_d"]),
            B.node("Erf", [f"{tag}_d"], [f"{tag}_e"]),
            B.node("Add", [f"{tag}_e", f"{tag}_one"], [f"{tag}_a"]),
            B.node("Mul", [src, f"{tag}_a"], [f"{tag}_m"]),
            B.node("Mul", [f"{tag}_m", f"{tag}_half"], [dst]),
        ]

    tp = t // 2
    inits = {"w_c1": f(0.3, d, m, 3), "b_c1": f(0.1, d),
             "w_c2": f(0.3, d, d, 3), "b_c2": f(0.1, d),
             "ln_g": f(1.0, d), "ln_b": f(1.0, d),
             "w_qkv": f(0.2, d, 3 * d), "w_o": f(0.2, d, d),
             "codebook": f(1.0, k, d),
             "two": np.asarray(2.0, np.float32),
             "ln_eps": np.asarray(1e-5, np.float32),
             "scale": np.asarray(1.0 / np.sqrt(d // h), np.float32),
             "minus_two": np.asarray(-2.0, np.float32),
             "head_shape": np.asarray([1, tp, h, d // h], np.int64),
             "flat_shape": np.asarray([1, tp, d], np.int64)}
    for tag in ("gelu1", "gelu2"):
        inits.update({f"{tag}_sqrt2": np.asarray(np.sqrt(2.0), np.float32),
                      f"{tag}_one": np.asarray(1.0, np.float32),
                      f"{tag}_half": np.asarray(0.5, np.float32)})
    nodes = [
        B.node("Conv", ["x", "w_c1", "b_c1"], ["c1"], kernel_shape=[3],
               pads=[1, 1]),
        *gelu("c1", "g1", "gelu1"),
        B.node("Conv", ["g1", "w_c2", "b_c2"], ["c2"], kernel_shape=[3],
               strides=[2], pads=[1, 1]),
        *gelu("c2", "g2", "gelu2"),
        B.node("Transpose", ["g2"], ["seq"], perm=[0, 2, 1]),
        B.node("ReduceMean", ["seq"], ["ln_mu"], axes=[-1], keepdims=1),
        B.node("Sub", ["seq", "ln_mu"], ["ln_c"]),
        B.node("Pow", ["ln_c", "two"], ["ln_sq"]),
        B.node("ReduceMean", ["ln_sq"], ["ln_var"], axes=[-1], keepdims=1),
        B.node("Add", ["ln_var", "ln_eps"], ["ln_ve"]),
        B.node("Sqrt", ["ln_ve"], ["ln_std"]),
        B.node("Div", ["ln_c", "ln_std"], ["ln_n"]),
        B.node("Mul", ["ln_n", "ln_g"], ["ln_s"]),
        B.node("Add", ["ln_s", "ln_b"], ["normed"]),
        B.node("MatMul", ["normed", "w_qkv"], ["qkv"]),
        B.node("Split", ["qkv"], ["q", "k", "vv"], axis=-1, num_outputs=3),
        B.node("Reshape", ["q", "head_shape"], ["q4"]),
        B.node("Reshape", ["k", "head_shape"], ["k4"]),
        B.node("Reshape", ["vv", "head_shape"], ["v4"]),
        B.node("Transpose", ["q4"], ["qh"], perm=[0, 2, 1, 3]),
        B.node("Transpose", ["k4"], ["kh"], perm=[0, 2, 3, 1]),
        B.node("Transpose", ["v4"], ["vh"], perm=[0, 2, 1, 3]),
        B.node("MatMul", ["qh", "kh"], ["scores_raw"]),
        B.node("Mul", ["scores_raw", "scale"], ["scores"]),
        B.node("Softmax", ["scores"], ["probs"], axis=-1),
        B.node("MatMul", ["probs", "vh"], ["ctx4"]),
        B.node("Transpose", ["ctx4"], ["ctx_t"], perm=[0, 2, 1, 3]),
        B.node("Reshape", ["ctx_t", "flat_shape"], ["ctx"]),
        B.node("MatMul", ["ctx", "w_o"], ["attn_out"]),
        B.node("Add", ["seq", "attn_out"], ["enc"]),
        B.node("Mul", ["enc", "enc"], ["e_sq"]),
        B.node("ReduceSum", ["e_sq"], ["e_ss"], axes=[-1], keepdims=1),
        B.node("Transpose", ["codebook"], ["cb_t"], perm=[1, 0]),
        B.node("MatMul", ["enc", "cb_t"], ["ec"]),
        B.node("Mul", ["ec", "minus_two"], ["m2ec"]),
        B.node("Mul", ["codebook", "codebook"], ["c_sq"]),
        B.node("ReduceSum", ["c_sq"], ["c_ss"], axes=[-1], keepdims=0),
        B.node("Add", ["e_ss", "m2ec"], ["dist_p"]),
        B.node("Add", ["dist_p", "c_ss"], ["dist"]),
        B.node("ArgMin", ["dist"], ["ids64"], axis=-1, keepdims=0),
        B.node("Cast", ["ids64"], ["token_ids"], to=6),
        B.node("Gather", ["codebook", "ids64"], ["quantized"], axis=0),
    ]
    return B.build(nodes, ["x"], ["token_ids", "quantized"], inits), x


@pytest.mark.parametrize("graph", ["campplus", "s3"])
def test_architecture_graphs_match_jax(graph):
    blob, x = {"campplus": campplus_shaped, "s3": s3_shaped}[graph]()
    assert audit_ops(blob) == jax_audit(blob)
    assert audit_ops(blob)["ok"]
    got, want = run_both(blob, x)
    assert_same(got, want)
    if graph == "s3":
        assert got[0].dtype == np.int32
        assert len(np.unique(got[0])) > 3          # not a constant id


def test_audit_reports_unsupported_like_jax():
    blob = B.build([B.node("LSTM", ["x", "w"], ["y"]),
                    B.node("Relu", ["y"], ["z"])], ["x"], ["z"],
                   {"w": np.zeros((2, 2), np.float32)})
    report = audit_ops(blob)
    assert report == jax_audit(blob)
    assert not report["ok"] and report["unsupported"] == ["LSTM"]
    assert audit_ops(onnx_import.load_onnx(blob)) == report


# ---------------------------------------------------------------------------
# ONNX's traps: each against the ONNX semantics, and JAX where it keeps them
# ---------------------------------------------------------------------------


def _trap_int_div():
    a = np.asarray([7, -7, 7, -7, 0, 5], np.int64)
    b = np.asarray([2, 2, -2, -2, 3, -5], np.int64)
    want = np.trunc(a / b).astype(np.int64)
    return B.build([B.node("Div", ["a", "b"], ["y"])], ["a", "b"], ["y"]), \
        (a, b), [want], False      # JAX's jnp.divide returns floats


def _trap_reshape():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    return B.build([B.node("Reshape", ["x", "s"], ["y"])], ["x"], ["y"],
                   {"s": np.asarray([0, -1, 2], np.int64)}), \
        (x,), [x.reshape(2, 6, 2)], True


def _trap_slice():
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    nodes = [B.node("Slice", ["x", "s1", "e1", "a1", "p1"], ["y1"]),
             B.node("Slice", ["x", "s2", "e2", "a2", "p2"], ["y2"]),
             B.node("Slice", ["x", "s3", "e3", "a3", "p3"], ["y3"])]
    i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
    init = {"s1": i64(1, 2), "e1": i64(INT64_MAX, INT64_MAX),
            "a1": i64(0, 1), "p1": i64(1, 2),
            "s2": i64(-1), "e2": i64(INT64_MIN), "a2": i64(1), "p2": i64(-1),
            "s3": i64(4, 10), "e3": i64(-7, 1), "a3": i64(0, 1),
            "p3": i64(-2, -2)}
    want = [x[1:, 2::2], x[:, ::-1], x[4::-2, 5:1:-2]]
    return B.build(nodes, ["x"], ["y1", "y2", "y3"], init), (x,), want, True


def _trap_gather():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.asarray([[-1, 0], [2, -4]], np.int64)
    want = np.take(x, np.where(idx < 0, idx + 4, idx), axis=0)
    return B.build([B.node("Gather", ["x", "i"], ["y"], axis=0)], ["x"],
                   ["y"], {"i": idx}), (x,), [want], True


def _trap_arg_ties():
    x = np.asarray([[3.0, 1.0, 1.0, 3.0], [2.0, 2.0, 2.0, 0.0]], np.float32)
    nodes = [B.node("ArgMin", ["x"], ["a"], axis=1, keepdims=1),
             B.node("ArgMax", ["x"], ["b"], axis=1, keepdims=0),
             B.node("ArgMax", ["x"], ["c"], axis=0, keepdims=1)]
    want = [np.asarray([[1], [3]]), np.asarray([0, 0]),
            np.asarray([[0, 1, 1, 0]])]
    return B.build(nodes, ["x"], ["a", "b", "c"]), (x,), want, True


def _trap_cast():
    x = np.asarray([-2.7, -0.5, 0.5, 1.9, 3.0], np.float32)
    nodes = [B.node("Cast", ["x"], ["a"], to=7), B.node("Cast", ["x"], ["b"], to=6)]
    return B.build(nodes, ["x"], ["a", "b"]), (x,), \
        [np.asarray([-2, 0, 0, 1, 3], np.int64),
         np.asarray([-2, 0, 0, 1, 3], np.int32)], True


def _trap_reduce_axes():
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    nodes = [B.node("ReduceSum", ["x"], ["a"], axes=[-1, 0], keepdims=1),
             B.node("ReduceMax", ["x"], ["b"], axes=[1], keepdims=0),
             B.node("ReduceL2", ["x"], ["c"], keepdims=0)]
    return B.build(nodes, ["x"], ["a", "b", "c"]), (x,), \
        [x.sum(axis=(0, 2), keepdims=True), x.max(axis=1),
         np.asarray(np.sqrt((x * x).sum()), np.float32)], True


def _trap_gelu():
    from scipy.special import erf
    x = np.linspace(-4, 4, 33).astype(np.float32)
    nodes = [B.node("Gelu", ["x"], ["a"]),
             B.node("Gelu", ["x"], ["b"], approximate="tanh")]
    xd = x.astype(np.float64)
    exact = 0.5 * xd * (1 + erf(xd / np.sqrt(2)))
    tanh = 0.5 * xd * (1 + np.tanh(np.sqrt(2 / np.pi) * (xd + 0.044715 * xd ** 3)))
    return B.build(nodes, ["x"], ["a", "b"]), (x,), \
        [exact.astype(np.float32), tanh.astype(np.float32)], True


def _trap_batchnorm_eps():
    r = np.random.RandomState(3)
    x = r.randn(2, 3, 5).astype(np.float32)
    s, b, m = (r.randn(3).astype(np.float32) for _ in range(3))
    v = np.asarray([1e-3, 0.5, 2.0], np.float32)
    nodes = [B.node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
                    epsilon=1e-2)]
    sh = (1, 3, 1)
    want = (x - m.reshape(sh)) / np.sqrt(v.reshape(sh) + 1e-2) * s.reshape(sh) \
        + b.reshape(sh)
    return B.build(nodes, ["x"], ["y"], {"s": s, "b": b, "m": m, "v": v}), \
        (x,), [want.astype(np.float32)], True


def _trap_conv():
    r = np.random.RandomState(4)
    x = r.randn(2, 4, 17).astype(np.float32)
    w = r.randn(6, 2, 3).astype(np.float32)
    bias = r.randn(6).astype(np.float32)
    nodes = [B.node("Conv", ["x", "w", "b"], ["y"], kernel_shape=[3],
                    pads=[3, 1], dilations=[2], group=2, strides=[2])]
    xt = torch.nn.functional.pad(torch.from_numpy(x), (3, 1))
    want = torch.nn.functional.conv1d(xt, torch.from_numpy(w),
                                      torch.from_numpy(bias), stride=2,
                                      dilation=2, groups=2).numpy()
    return B.build(nodes, ["x"], ["y"], {"w": w, "b": bias}), (x,), [want], True


TRAPS = {"int_div": _trap_int_div, "reshape_0_-1": _trap_reshape,
         "slice_int64max_negative_steps": _trap_slice,
         "gather_negative": _trap_gather, "argmin_argmax_ties": _trap_arg_ties,
         "cast_truncates": _trap_cast, "reduce_axes_attribute": _trap_reduce_axes,
         "gelu_erf_and_tanh": _trap_gelu, "batchnorm_epsilon": _trap_batchnorm_eps,
         "conv_pads_groups_dilations": _trap_conv}


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_onnx_traps(trap):
    blob, args, want, jax_keeps_it = TRAPS[trap]()
    got = _outs(OnnxTorchFunction.from_file(blob, device="cpu")(*args))
    assert_same(got, want)
    if jax_keeps_it:
        assert_same(got, _outs(OnnxJaxFunction.from_file(blob)(*args)))
    else:
        ref = _outs(OnnxJaxFunction.from_file(blob)(*args))
        assert any(not np.array_equal(g, r) for g, r in zip(got, ref))


# ---------------------------------------------------------------------------
# the processor hooks
# ---------------------------------------------------------------------------


def test_processor_hooks_match_jax():
    from taste_spokenlm_tpu.frontend.processor import (
        s3_tokenizer_from_onnx as jax_s3, speaker_embedder_from_onnx as jax_spk)
    from taste_spokenlm_tpu_torch.frontend.processor import (
        s3_tokenizer_from_onnx, speaker_embedder_from_onnx)
    r = np.random.RandomState(0)
    w = (r.randn(192, 80) * 0.1).astype(np.float32)
    spk_blob = B.build(
        [B.node("ReduceMean", ["feats"], ["m"], axes=[1], keepdims=0),
         B.node("Gemm", ["m", "w"], ["xvec"], transB=1)],
        ["feats"], ["xvec"], {"w": w})
    feats = r.randn(1, 50, 80).astype(np.float32)
    got = speaker_embedder_from_onnx(spk_blob, device="cpu")(feats)
    want = jax_spk(spk_blob)(feats)
    assert got.shape == (192,) and got.dtype == np.float32
    assert_same([got], [want])

    cw = (r.randn(16, 128, 3) * 0.1).astype(np.float32)
    pw = r.randn(16, 64).astype(np.float32)
    s3_blob = B.build(
        [B.node("Conv", ["mel", "cw"], ["h"], kernel_shape=[3], strides=[2],
                pads=[1, 1]),
         B.node("Transpose", ["h"], ["ht"], perm=[0, 2, 1]),
         B.node("MatMul", ["ht", "pw"], ["logits"]),
         B.node("ArgMax", ["logits"], ["ids"], axis=-1, keepdims=0),
         B.node("Cast", ["ids"], ["ids64"], to=7)],
        ["mel", "mel_len"], ["ids64"], {"cw": cw, "pw": pw})
    mel = r.randn(1, 128, 200).astype(np.float32)
    got = s3_tokenizer_from_onnx(s3_blob, device="cpu")(mel, 120)
    want = jax_s3(s3_blob)(mel, 120)
    assert got.shape == (60,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a tensor mel (the processor's device output) gives the same ids
    np.testing.assert_array_equal(
        s3_tokenizer_from_onnx(s3_blob, device="cpu")(torch.from_numpy(mel),
                                                      120), want)


def test_executor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    blob = B.build([B.node("Relu", ["x"], ["y"])], ["x"], ["y"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnnxTorchFunction.from_file(blob)
