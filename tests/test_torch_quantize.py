"""The port's block-scaled codecs (horovod_tpu_torch.ops.quantize) against
the JAX package's (horovod_tpu.ops.quantize), bit for bit, on the CPU.

The JAX side runs both ways it runs off the TPU: its Pallas kernels through
the Pallas interpreter (``interpret=True``) and its jnp version of the same
arithmetic (``interpret=None``).  The port's side is the plain version of
its kernels, which a CPU tensor takes.  Inputs come from numpy with a seed.

The reference promises bit-identity with the C++ codec
(``horovod_tpu/cpp/wire_codec.h``) and across ranks.  Three places where the
JAX package, run by XLA on the CPU, breaks that promise and the port keeps
the C++ codec's arithmetic are pinned at the end (ROADMAP Queue 3).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.ops.collectives as jcl
import horovod_tpu.ops.quantize as jq
import horovod_tpu.utils.env as jenv
from horovod_tpu_torch.ops import collectives as tcl
from horovod_tpu_torch.ops import quantize as tq
from horovod_tpu_torch.utils import env as tenv

REPO = Path(__file__).resolve().parent.parent
CODECS = ("int8", "int4", "int8g")
F32 = np.finfo(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that idle OpenMP
    workers do not spin on a CPU the other test processes share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random():
    """Two int8g groups of unit normals with a few loud blocks."""
    x = np.random.default_rng(1).standard_normal(2 * 4096).astype(np.float32)
    x[1024:1280] *= 1e4
    x[5000:5256] *= 1e-4
    return x


def _adversarial():
    """A ragged length (last block 37 long) and every special block: all
    zeros, all NaN, a NaN in a finite block, +-inf blocks, an inf in a
    finite block, +-FLT_MAX, subnormal elements beside normal ones, -0.0,
    and values at exactly k + 0.5 quantization steps (scale 1)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(256 * 12 + 37).astype(np.float32)
    x[0:256] = 0.0
    x[256:512] = np.nan
    x[600] = np.nan
    x[768:1024] = np.inf
    x[1024:1280] = -np.inf
    x[1300] = np.inf
    x[1536:1792] *= 1e-30
    x[1536:1546] = F32.smallest_subnormal * np.arange(1, 11)
    x[1792], x[1793] = F32.max, -F32.max
    x[2048:2304] = np.arange(256) % 20 - 10 + 0.5   # ties, half to even
    x[2048] = 127.0                                  # scale exactly 1
    x[2304:2560] = -0.0
    x[2560:2816] = np.arange(256) % 14 - 7 + 0.5     # int4 ties, scale 1
    x[2560] = 7.0
    return x


INPUTS = {"random": _random, "adversarial": _adversarial}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_bitwise(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    diff = np.flatnonzero(_bits(got) != _bits(want))
    assert diff.size == 0, (f"{what}: {diff.size} differ, first at "
                            f"{diff[:5]}")


def _assert_payload(got, want, codec, what):
    _assert_bitwise(got[0], want[0], what + " codes")
    if codec == "int8g":
        _assert_bitwise(got[1][0], want[1][0], what + " sub-scales")
        _assert_bitwise(got[1][1], want[1][1], what + " group scales")
    else:
        _assert_bitwise(got[1], want[1], what + " scales")


@pytest.mark.parametrize("interpret", [True, None],
                         ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("codec", CODECS)
def test_codec_matches_jax_bitwise(codec, kind, interpret):
    x = INPUTS[kind]()
    n = x.size
    tq.reset_launch_counts()
    got = tq.quantize(torch.from_numpy(x), codec)
    want = jq.quantize(jnp.asarray(x), codec, interpret)
    _assert_payload(got, want, codec, f"{codec} {kind} quantize")
    _assert_bitwise(tq.dequantize(*got, n, codec),
                    jq.dequantize(*want, n, codec, interpret),
                    f"{codec} {kind} dequantize")
    if interpret is None:  # the same kernels again, composed
        _assert_bitwise(tq.fake_quantize(torch.from_numpy(x), codec),
                        jq.fake_quantize(jnp.asarray(x), codec, interpret),
                        f"{codec} {kind} fake_quantize")
    if codec == "int8":
        xb = x[:n // 256 * 256].reshape(-1, 256)
        gotb = tq.quantize_blocks(torch.from_numpy(xb))
        wantb = jq.quantize_blocks(jnp.asarray(xb), interpret)
        _assert_payload(gotb, wantb, codec, f"{kind} quantize_blocks")
        _assert_bitwise(tq.dequantize_blocks(*gotb),
                        jq.dequantize_blocks(*wantb, interpret),
                        f"{kind} dequantize_blocks")
    # CPU tensors take the plain versions: no kernel ran.
    assert tq.LAUNCHES == {"quant_int8": 0, "quant_int4": 0, "dequant": 0}


def test_constants_mirror_jax_and_cpp():
    header = (REPO / "horovod_tpu/cpp/wire_codec.h").read_text()
    cpp = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int64_t (kWire\w+) = (\d+);", header)}
    pairs = {"WIRE_BLOCK": "kWireBlock", "WIRE_SCALE_BYTES": "kWireScaleBytes",
             "WIRE_GROUP": "kWireGroup", "WIRE_INT4_MAX": "kWireInt4Max",
             "WIRE_SUB_DENOM": "kWireSubDenom"}
    for name, cname in pairs.items():
        assert getattr(tq, name) == getattr(jq, name) == cpp[cname], name
    assert tq.WIRE_CODEC_IDS == jq.WIRE_CODEC_IDS
    assert tq.DEVICE_WIRE_CODECS == jq.DEVICE_WIRE_CODECS
    assert tenv.DEVICE_SCHEDULES == jenv.DEVICE_SCHEDULES
    assert tenv.DEVICE_WIRE_COMPRESSION_CODECS == \
        jenv.DEVICE_WIRE_COMPRESSION_CODECS


def test_byte_arithmetic_matches_jax():
    counts = [0, 1, 2, 255, 256, 257, 4095, 4096, 4097, 65536 + 37,
              10 ** 6 + 3]
    for count in counts:
        for codec in ("none", "bf16") + CODECS:
            assert tq.encoded_nbytes(count, codec) == \
                jq.encoded_nbytes(count, codec)
        for world in (1, 2, 3, 4, 6, 8, 9, 12, 16, 64):
            for codec in CODECS:
                for sched in ("ring", "bidi", "torus"):
                    assert tq.ring_bytes(count, world, codec, sched) == \
                        jq.ring_bytes(count, world, codec, sched)
    for world in range(1, 70):
        assert tq.torus_factors(world) == jq.torus_factors(world)
        for sched in (None, "auto", "ring", "bidi", "torus", "bogus"):
            assert tcl.resolve_device_schedule(world, sched or "auto") == \
                jcl.resolve_device_schedule(world, sched or "auto")


@pytest.mark.parametrize("value", [
    None, "", "0", "off", "int8", "bf16", "device=int8", "device=int4",
    "host=bf16,device=int8g", " Device = INT8 ", "device=bf16",
    "device=int8,host=int4", "gpu=int8", "int9", "host=int8,device=nope"])
def test_wire_compression_env_matches_jax(monkeypatch, value):
    for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE"):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert tenv.get_wire_compression_planes() == \
        jenv.get_wire_compression_planes()
    assert tenv.get_device_schedule() == jenv.get_device_schedule()


def test_min_bytes_and_gpu_operations_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", raising=False)
    assert tenv.get_wire_compression_min_bytes() == 1 << 16 == \
        jenv.Config().wire_compression_min_bytes
    monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", "4096")
    assert tenv.get_wire_compression_min_bytes() == 4096
    monkeypatch.delenv("HOROVOD_GPU_OPERATIONS", raising=False)
    assert tenv.Config.from_env().gpu_operations == "NCCL"
    monkeypatch.setenv("HOROVOD_GPU_OPERATIONS", "gloo")
    assert tenv.Config.from_env().gpu_operations == "GLOO"
    monkeypatch.setenv("HOROVOD_GPU_OPERATIONS", "MPI")
    with pytest.raises(ValueError, match="HOROVOD_GPU_OPERATIONS"):
        tenv.Config.from_env()


def test_codec_configuration_is_read_once_at_init(monkeypatch):
    """As in the reference's context: hvd.init() reads the device codec,
    its floor and the ring schedule once; before init the environment is
    read."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION", "device=int4")
    monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", "4096")
    monkeypatch.setenv("HOROVOD_DEVICE_SCHEDULE", "bidi")
    hvd.init(device="cpu")
    try:
        monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION", "device=int8g")
        monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", "1")
        monkeypatch.setenv("HOROVOD_DEVICE_SCHEDULE", "ring")
        assert tcl._device_codec_defaults() == ("int4", 4096)
        assert tcl.resolve_device_schedule(4) == "bidi"
    finally:
        hvd.shutdown()
    assert tcl._device_codec_defaults() == ("int8g", 1)
    assert tcl.resolve_device_schedule(4) == "ring"


def test_kernel_wrappers_refuse_other_layouts():
    """The CUDA wrappers check before they build or launch anything: rows
    of another width, a dtype the kernel does not take, a view that is not
    16-byte aligned, and scales of the wrong shape all raise."""
    xb = torch.zeros(4, 256)
    inv = torch.ones(4, 1)
    with pytest.raises(ValueError, match="256"):
        tq.quant_int8_cuda(torch.zeros(4, 128), inv)
    with pytest.raises(TypeError, match="float32"):
        tq.quant_int4_cuda(xb.double(), inv)
    with pytest.raises(ValueError, match="aligned"):
        tq.quant_int8_cuda(torch.zeros(5 * 256 + 1)[1:].view(5, 256),
                           torch.ones(5, 1))
    with pytest.raises(ValueError, match="scales"):
        tq.dequant_cuda(torch.zeros(4, 256, dtype=torch.int8),
                        torch.ones(4))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        tq.dequantize_blocks(torch.zeros(4, 256, dtype=torch.int8),
                             torch.ones(4, 1, device="meta"))


# --- Where the JAX package on XLA's CPU departs from the C++ codec --------

def test_reference_flushes_subnormal_scales():
    """XLA's CPU backend flushes subnormals to zero.  A block whose max|x|
    is below 127 times the smallest normal float has a subnormal scale in
    the C++ codec (``maxabs / 127.0f``, IEEE), and the port keeps it; the
    JAX package's scale is 0 and the block's codes with it.  Pinned at
    both of its dispatch modes (ROADMAP Queue 3)."""
    x = np.zeros(256, np.float32)
    x[:4] = [1e-40, -3e-40, 2e-41, F32.smallest_subnormal]
    port_codes, port_scale = tq.quantize(torch.from_numpy(x), "int8")
    cpp_scale = np.float32(3e-40) / np.float32(127.0)   # numpy: IEEE
    assert cpp_scale > 0
    _assert_bitwise(port_scale.reshape(()), cpp_scale, "port scale")
    assert port_codes.abs().max() == 127
    for interpret in (True, None):
        codes, scale = jq.quantize(jnp.asarray(x), "int8", interpret)
        assert float(scale[0, 0]) == 0.0
        assert not np.any(np.asarray(codes))


def test_reference_traced_scale_divides_by_a_rounded_reciprocal():
    """Inside ``jit`` XLA's algebraic simplifier turns the scale's
    ``max|x| / 127`` into ``max|x| * fl(1/127)``, 1 ulp off the correctly
    rounded quotient the C++ codec (and the JAX package's own docstring)
    computes, in some blocks.  The port divides; the parity tests compile
    the reference with that pass off."""
    x = _random()
    xb = x.reshape(-1, 256)
    maxabs = np.abs(xb).max(axis=1)
    divided = maxabs / np.float32(127.0)
    multiplied = maxabs * np.float32(1.0 / 127.0)
    assert np.any(divided != multiplied)
    traced = np.asarray(jax.jit(lambda v: jq.quantize(v, "int8")[1])(
        jnp.asarray(x))).reshape(-1)
    _assert_bitwise(traced, multiplied, "traced reference scales")
    port = tq.quantize(torch.from_numpy(x), "int8")[1].reshape(-1)
    _assert_bitwise(port, divided, "port scales")


def test_reference_traced_decode_and_add_fuses_into_fma():
    """At XLA's default CPU optimization level the ring's hop arithmetic,
    ``dequantize(payload) + own``, compiles to one fused multiply-add per
    element; the C++ ring and the port round the product first.  The
    parity tests compile the reference at optimization level 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    own = rng.standard_normal(4096).astype(np.float32)
    codes, scales = tq.quantize(torch.from_numpy(x), "int8")
    c, s = codes.numpy(), scales.numpy()
    two_step = (s * c.astype(np.float32)).reshape(-1) + own
    fused = (s.astype(np.float64) * c).reshape(-1) + own.astype(np.float64)
    fused = fused.astype(np.float32)
    assert np.any(two_step != fused)
    traced = np.asarray(jax.jit(
        lambda q, sc, o: jq.dequantize(q, sc, 4096, "int8") + o)(c, s, own))
    _assert_bitwise(traced, fused, "traced reference hop")
    port = tq.dequantize(codes, scales, 4096, "int8") + torch.from_numpy(own)
    _assert_bitwise(port, two_step, "port hop")
