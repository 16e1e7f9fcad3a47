"""Port vs JAX package: the codec's quantize + pack stage, byte for byte.

The port's plain version (what a CPU tensor runs) must emit the same bytes
and scales as the JAX Pallas kernel (interpret mode), its jnp reference and
the numpy wire path, and the same decoded bits. The CUDA kernel is held to
the plain version on the card (``cuda`` marker; skips without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import codec as jcodec
from fedml_tpu.ops.pallas.agg_quant import fused_quantize_pack
from fedml_tpu_torch.comm import codec as tcodec
from fedml_tpu_torch.ops import agg_quant as aq


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _vals(C, m, seed):
    v = np.random.default_rng(seed).standard_normal((C, m)).astype(np.float32)
    v[0, :5] = 0.0
    if m > 300:
        v[-1, 256:512] = 0.0  # a whole zero chunk: scale 1.0
        v[-1, 0] = np.inf     # inf absmax: scale 2^-eb, level +bound
    return v


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,m", [(1, 64), (3, 256), (5, 700), (4, 257), (13, 1000)])
def test_plain_equals_jax_kernel_and_wire(bits, C, m):
    vals = _vals(C, m, bits * 100 + C)
    seed, rnd, lh = 13, 2, jcodec._leaf_hash("params/Dense_0/kernel")
    cids = np.arange(10, 10 + C, dtype=np.uint32) * 7
    jp, js, jd = fused_quantize_pack(jnp.asarray(vals), bits, seed, jnp.uint32(rnd),
                                     jnp.asarray(cids), lh, interpret=True)
    tp, ts, td = aq.quantize_pack(torch.from_numpy(vals), bits, seed, rnd,
                                  torch.from_numpy(cids.astype(np.int32)), lh)
    assert tp.dtype == (torch.int8 if bits == 8 else torch.uint8)
    _eq(tp.numpy(), jp, "packed bytes vs JAX kernel")
    _eq(ts.numpy(), js, "scales vs JAX kernel")
    _eq(td.numpy().view(np.uint32), np.asarray(jd).view(np.uint32), "dec bits vs JAX kernel")
    for c in range(C):
        if not np.isfinite(vals[c]).all():
            continue  # the wire path's numpy scale differs only for inf chunks
        q, s, d = jcodec.stochastic_quantize(vals[c], bits, seed, rnd, int(cids[c]), lh)
        wire = jcodec.pack_int4(q) if bits == 4 else q
        _eq(tp[c].numpy(), wire, f"row {c} vs JAX wire bytes")
        _eq(ts[c].numpy(), s, f"row {c} vs JAX wire scales")
        # the port's own numpy wire path is the same stream
        q2, s2, d2 = tcodec.stochastic_quantize(vals[c], bits, seed, rnd, int(cids[c]), lh)
        _eq(tcodec.pack_int4(q2) if bits == 4 else q2, wire, f"row {c} port wire")
        _eq(d2, d)


def test_nan_values_decode_like_xla():
    """A NaN element gives its chunk scale 1.0 and level 0 (XLA converts
    NaN to integer 0)."""
    vals = np.ones((2, 300), np.float32)
    vals[1, 3] = np.nan
    cids = np.array([1, 2], np.uint32)
    jp, js, jd = fused_quantize_pack(jnp.asarray(vals), 8, 0, jnp.uint32(0),
                                     jnp.asarray(cids), 5, interpret=True)
    tp, ts, td = aq.quantize_pack(torch.from_numpy(vals), 8, 0, 0,
                                  torch.from_numpy(cids.astype(np.int32)), 5)
    _eq(tp.numpy(), jp)
    _eq(ts.numpy(), js)
    _eq(td.numpy(), jd)


def test_hash_chain_matches_jax():
    for seed, rnd, cid, lh in [(0, 0, 0, 0), (13, 2, 999, 0xDEADBEEF), (2**31, 7, 5, 1)]:
        want = jcodec.stochastic_key(seed, rnd, cid, lh)
        assert tcodec.stochastic_key(seed, rnd, cid, lh) == want
        key = aq._mix32(aq._mix32(torch.tensor([aq.round_key(seed, rnd) ^ cid])) ^ lh)
        assert int(key[0]) == want


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    before = aq.quantize_pack.launches
    aq.quantize_pack(torch.ones(2, 64), 8, 0, 0, torch.zeros(2, dtype=torch.int32))
    assert aq.quantize_pack.launches == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        aq.quantize_pack(torch.ones(2, 64, dtype=torch.float64), 8, 0, 0,
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        aq.quantize_pack(torch.ones(2, 64), 8, 0, 0, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        aq.quantize_pack(torch.ones(2, 64), 5, 0, 0, torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------ codec roundtrip (slice (d))

def _cnn_tree(C):
    from fedml_tpu.models import create, init_params

    class A:
        model, dataset = "cnn_fedavg", "mnist"

    v = init_params(create(A, 10), jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    rng = np.random.default_rng(4)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal((C,) + p.shape) * 0.01).astype(np.float32), v)


@pytest.mark.parametrize("spec", ["q8", "delta|q4"])
def test_roundtrip_on_cnn_tree_matches_jax(spec):
    C, seed, rnd = 3, 11, 4
    tree = _cnn_tree(C)
    jpaths, _, _ = jcodec._flatten_with_paths(tree)
    tpaths, _ = tcodec._flatten_with_paths(tree)
    assert tpaths == jpaths
    assert [tcodec._leaf_hash(p) for p in tpaths] == [jcodec._leaf_hash(p) for p in jpaths]
    cids = np.array([5, 900, 31], np.uint32)
    jrt = jcodec.build_stacked_roundtrip(spec, seed, agg_kernels=True)
    jdec, _ = jrt(jax.tree_util.tree_map(jnp.asarray, tree), (), jnp.asarray(cids),
                  jnp.uint32(rnd))
    from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax

    trt = tcodec.build_stacked_roundtrip(spec, seed)
    tdec = trt(variables_from_jax(tree), torch.from_numpy(cids.astype(np.int32)), rnd)
    jflat = flatten_paths(jax.tree_util.tree_map(np.asarray, jdec))
    assert list(tdec) == list(jflat)
    for p, v in jflat.items():
        _eq(tdec[p].numpy().view(np.uint32), v.view(np.uint32), p)


def test_topk_stage_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcodec.build_stacked_roundtrip("topk:0.1|q8", 0)


def test_parse_codec_spec_matches_jax():
    for s in ["q8", "delta|q4", "delta|topk:0.01|q8"]:
        a, b = jcodec.parse_codec_spec(s), tcodec.parse_codec_spec(s)
        assert (a.delta, a.topk, a.bits) == (b.delta, b.topk, b.bits)
    for bad in ["q8|delta", "q8|q4", "zip", ""]:
        with pytest.raises(ValueError):
            tcodec.parse_codec_spec(bad)


# ------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,m", [(10, 1605632), (10, 64), (13, 1000), (1, 257)])
def test_kernel_equals_plain_on_card(cuda_device, bits, C, m):
    vals = torch.from_numpy(_vals(C, m, 1)).to(cuda_device)
    cids = torch.arange(C, dtype=torch.int32, device=cuda_device)
    before = aq.quantize_pack.launches
    k = aq.quantize_pack(vals, bits, 3, 1, cids, 77)
    p = aq.quantize_pack_plain(vals, bits, 3, 1, cids, 77)
    assert aq.quantize_pack.launches == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.int8 else a,
                           b.view(torch.uint8) if b.dtype == torch.int8 else b)
