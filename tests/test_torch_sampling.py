"""The port's token sampling against the JAX package, on the CPU.

`generate`, `generate_kv`, `quantized_generate_kv` and
`WeldingQualityPipeline.sample_tokens` on bridged weights (d32, 2
blocks, 4 heads, 33 tokens, 34 classes). Greedy ids must equal JAX's
for every prompt case; sampled ids must equal JAX's when both packages
get the same Gumbel noise (`jax.random.categorical` is an argmax over
logits plus Gumbel noise; the test draws that noise from the JAX keys
and hands it to the port through `noise=`). Step logits are held to
1e-5: both sides are f32 and differ in summation order only. The int8
sampler keeps the JAX package's own contract (tests/test_quantized.py):
cached step logits within 1e-4 of the full int8 forward on a forced
sequence.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu_torch.models import quantized as pq
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)

import torch_port_helpers as H

N_CLASSES = H.K + 2
START = H.K


def _np(t):
    return t.detach().cpu().numpy()


def _prompt(case: str) -> tuple[np.ndarray, int | None]:
    """(ids, num_steps) of the cases of tests/test_models.py:123-201."""
    rng = np.random.default_rng(11)
    if case == "start":                 # one start token, default steps
        return np.full((3, 1), START, np.int32), None
    if case == "prompt":                # t0 > 1; 4 + 33 steps crop the tail
        return rng.integers(0, H.K, (3, 4)).astype(np.int32), None
    if case == "overrun":               # steps far past seq_len
        return np.full((2, 1), START, np.int32), H.SEQ_LEN + 12
    assert case == "long_prompt"        # the prompt is past seq_len already
    return rng.integers(0, H.K, (2, H.SEQ_LEN + 4)).astype(np.int32), 6


CASES = ["start", "prompt", "overrun", "long_prompt"]


@pytest.mark.parametrize("fn", ["generate", "generate_kv"])
@pytest.mark.parametrize("case", CASES)
def test_greedy_ids_equal_jax(case, fn):
    jm, params = H.jax_transformer()
    port = H.port_transformer()
    ids, steps = _prompt(case)
    ref = getattr(jm, fn)(params, jnp.asarray(ids), do_sample=False,
                          num_steps=steps)
    out = getattr(port, fn)(torch.from_numpy(ids), do_sample=False,
                            num_steps=steps)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def _jax_noise(key, steps: int, b: int) -> np.ndarray:
    """The Gumbel noise jax.random.categorical adds at each step."""
    return np.stack([np.asarray(jax.random.gumbel(k, (b, N_CLASSES)))
                     for k in jax.random.split(key, steps)])


@pytest.mark.parametrize("fn", ["generate", "generate_kv"])
@pytest.mark.parametrize("case", ["start", "prompt"])
def test_sampled_ids_equal_jax_on_the_same_noise(case, fn):
    jm, params = H.jax_transformer()
    port = H.port_transformer()
    ids, _ = _prompt(case)
    key = jax.random.PRNGKey(7)
    ref = getattr(jm, fn)(params, jnp.asarray(ids), do_sample=True, top_k=5,
                          rng=key)
    out = getattr(port, fn)(torch.from_numpy(ids), do_sample=True, top_k=5,
                            noise=_jax_noise(key, H.SEQ_LEN, len(ids)))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_top_k_keeps_ties_at_the_kth_value():
    port = H.port_transformer()
    last = torch.tensor([[0.0, 2.0, 2.0, 1.0, 3.0]])
    noise = torch.tensor([[0.0, 0.0, 9.0, 50.0, 0.0]])
    # k = 2: the threshold is 2.0 and both 2.0 entries stay; 1.0 is cut
    # even though its noise is the largest
    got = port._sample_from_logits(last, noise, True, 2)
    assert got.tolist() == [2]
    assert port._sample_from_logits(last, None, False, 2).tolist() == [4]


def test_generator_sampling_is_reproducible_and_in_range():
    port = H.port_transformer()
    start = torch.full((4, 1), START, dtype=torch.int32)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a = port.generate(start, do_sample=True, top_k=5, generator=gen(3))
    b = port.generate_kv(start, do_sample=True, top_k=5, generator=gen(3))
    c = port.generate_kv(start, do_sample=True, top_k=5, generator=gen(4))
    np.testing.assert_array_equal(_np(a), _np(b))
    assert a.shape == (4, 1 + H.SEQ_LEN)
    assert (_np(a) >= 0).all() and (_np(a) < N_CLASSES).all()
    assert (_np(b) != _np(c)).any()
    # no generator: one seeded with 0
    d = port.generate_kv(start, do_sample=True, top_k=5)
    e = port.generate_kv(start, do_sample=True, top_k=5, generator=gen(0))
    np.testing.assert_array_equal(_np(d), _np(e))


def test_noise_of_the_wrong_shape_is_refused():
    port = H.port_transformer()
    start = torch.full((2, 1), START, dtype=torch.int32)
    with pytest.raises(ValueError, match="noise"):
        port.generate_kv(start, do_sample=True, num_steps=3,
                         noise=np.zeros((3, 2, N_CLASSES - 1), np.float32))


def _caches(model, b):
    hd = model.d_model // model.n_head
    return [(torch.zeros(b, model.n_head, model.seq_len, hd),
             torch.zeros(b, model.n_head, model.seq_len, hd))
            for _ in range(model.n_blocks)]


def test_prefill_and_token_step_match_jax():
    """A forced sequence: prefill 3 tokens, step through the rest; every
    step's logits against JAX's step and against the port's own full
    forward, 1e-5 (f32 on both sides, other summation orders)."""
    jm, params = H.jax_transformer()
    port = H.port_transformer()
    ids = H.token_ids(4, seed=5)
    hd = jm.d_model // jm.n_head
    jc = [(jnp.zeros((4, jm.n_head, jm.seq_len, hd)),
           jnp.zeros((4, jm.n_head, jm.seq_len, hd))) for _ in range(2)]
    pc = _caches(port, 4)
    tids = torch.from_numpy(ids)
    full = _np(port.apply(tids))
    jl, jc = jm._prefill(params, jnp.asarray(ids[:, :3]), jc)
    pl, pc = port._prefill(tids[:, :3], pc)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(pl), full[:, 2], rtol=0, atol=1e-5)
    for pos in range(3, H.SEQ_LEN):
        jl, jc = jm._token_step(params, jnp.asarray(ids[:, pos]), pos, jc)
        pl, pc = port._token_step(tids[:, pos], pos, pc)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(pl), full[:, pos], rtol=0, atol=1e-5)
    for (pk, pv), (jk, jv) in zip(pc, jc):
        np.testing.assert_allclose(_np(pk), np.asarray(jk), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=0,
                                   atol=1e-5)


OPTIONS = {
    "cache_bf16": dict(cache_dtype=torch.bfloat16),
    "param_bf16": dict(param_dtype=torch.bfloat16),
    "cache_and_param_bf16": dict(cache_dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16),
    "buckets_2": dict(cache_buckets=2),
    "buckets_4": dict(cache_buckets=4),
    "buckets_16": dict(cache_buckets=16),
    "scan_unroll_4": dict(scan_unroll=4),
}


@functools.cache
def _exact_greedy():
    port = H.port_transformer()
    prompt = torch.from_numpy(_prompt("prompt")[0])
    return prompt, port.generate_kv(prompt, do_sample=False, num_steps=12)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_generate_kv_options_keep_greedy_ids(name):
    """At this size the bf16 cache, bf16 weights and the bucketed cache
    reads reproduce the exact path's greedy ids
    (tests/test_models.py:326-358); scan_unroll changes nothing."""
    prompt, ref = _exact_greedy()
    out = H.port_transformer().generate_kv(prompt, do_sample=False,
                                           num_steps=12, **OPTIONS[name])
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("kw,match", [
    (dict(param_dtype=torch.bfloat16), "param_dtype"),
    (dict(scan_unroll=2), "scan_unroll"),
    (dict(cache_buckets=8), "cache_buckets"),
    (dict(cache_dtype=torch.bfloat16), "cache_dtype"),
])
def test_options_that_need_the_xla_step_raise_with_fused(kw, match):
    prompt, _ = _exact_greedy()
    with pytest.raises(ValueError, match=match):
        H.port_transformer().generate_kv(prompt, decode_impl="fused", **kw)


@pytest.mark.parametrize("kw", [dict(scan_unroll=0), dict(scan_unroll=1.5),
                                dict(decode_impl="pallas")])
def test_generate_kv_refuses_bad_values(kw):
    prompt, _ = _exact_greedy()
    with pytest.raises(ValueError):
        H.port_transformer().generate_kv(prompt, **kw)


def test_bf16_weights_sum_in_f32():
    """dot_f32 on bf16 weights: the activation rounds to bf16, the sums
    stay f32 (the result is not rounded to bf16)."""
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        dot_f32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    out = dot_f32(x, w.bfloat16())
    ref = jnp.dot(jnp.asarray(_np(x)).astype(jnp.bfloat16),
                  jnp.asarray(_np(w)).astype(jnp.bfloat16).T,
                  preferred_element_type=jnp.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert (out != out.bfloat16().float()).any()


# -- the int8 sampler ---------------------------------------------------------

@functools.cache
def _calibrated():
    jm, params = H.jax_transformer()
    ids = H.token_ids(6, seed=2)
    jam = jq.calibrate_activation_absmax(jm, params, jnp.asarray(ids))
    jqp = jq.quantize_transformer(params, jam)
    return jm, jqp, H.port_transformer(), H.port_qparams(jqp)


def test_quantized_lm_logits_match_jax():
    """The classify tests' bound for the plain int8 chain: 1e-4 on
    bridged qparams."""
    jm, jqp, port, qp = _calibrated()
    ids = H.token_ids(4, seed=6)
    ref = jq.quantized_lm_logits(jm, jqp, jnp.asarray(ids))
    out = pq.quantized_lm_logits(port, qp, torch.from_numpy(ids))
    assert out.shape == (4, H.SEQ_LEN, N_CLASSES)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-4)


def test_quantized_kv_steps_match_the_full_int8_forward():
    """tests/test_quantized.py:172-204: cached logits over a forced
    sequence against the batched int8 forward at every position (the
    same calibrated scales give the same quantization), 1e-4, argmax
    equal; and against JAX's cached step."""
    jm, jqp, port, qp = _calibrated()
    ids = H.token_ids(4, seed=7)
    tids = torch.from_numpy(ids)
    full = _np(pq.quantized_lm_logits(port, qp, tids))
    pc = _caches(port, 4)
    hd = jm.d_model // jm.n_head
    jc = [(jnp.zeros((4, jm.n_head, jm.seq_len, hd)),
           jnp.zeros((4, jm.n_head, jm.seq_len, hd))) for _ in range(2)]
    logits, pc = pq._q_prefill(port, qp, tids[:, :3], pc)
    jl, jc = jq._q_prefill(jm, jqp, jnp.asarray(ids[:, :3]), jc)
    np.testing.assert_allclose(_np(logits), full[:, 2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), rtol=0,
                               atol=1e-4)
    for pos in range(3, H.SEQ_LEN):
        logits, pc = pq._q_token_step(port, qp, tids[:, pos], pos, pc)
        np.testing.assert_allclose(_np(logits), full[:, pos], rtol=1e-4,
                                   atol=1e-4)
        assert (_np(logits).argmax(-1) == full[:, pos].argmax(-1)).all()
    jl, jc = jq._q_token_step(jm, jqp, jnp.asarray(ids[:, 3]), 3, jc)
    np.testing.assert_allclose(full[:, 3], np.asarray(jl), rtol=0, atol=1e-4)


def test_quantized_generate_kv_equals_its_recompute_loop():
    """The self-consistency contract: greedy ids equal a greedy loop
    over quantized_lm_logits full forwards."""
    _, _, port, qp = _calibrated()
    prompt = torch.from_numpy(_prompt("prompt")[0])
    out = pq.quantized_generate_kv(port, qp, prompt, do_sample=False,
                                   num_steps=10)
    buf = prompt
    for _ in range(10):
        nxt = pq.quantized_lm_logits(port, qp, buf)[:, -1].argmax(-1)
        buf = torch.cat([buf, nxt[:, None].to(buf.dtype)], dim=1)
    np.testing.assert_array_equal(_np(out), _np(buf))


@pytest.mark.parametrize("case", CASES)
def test_quantized_generate_kv_is_valid(case):
    """The free-running int8 sampler for prompts of any length, the
    overrun past seq_len included: shape, range, prompt kept."""
    _, _, port, qp = _calibrated()
    ids, steps = _prompt(case)
    out = _np(pq.quantized_generate_kv(
        port, qp, torch.from_numpy(ids), do_sample=True, top_k=5,
        generator=torch.Generator().manual_seed(1), num_steps=steps))
    n = H.SEQ_LEN if steps is None else steps
    assert out.shape == (len(ids), ids.shape[1] + n)
    assert (out >= 0).all() and (out < N_CLASSES).all()
    np.testing.assert_array_equal(out[:, :ids.shape[1]], ids)


# -- serve.sample_tokens -------------------------------------------------------

def _pipeline(precision="f32"):
    return WeldingQualityPipeline(H.port_vqvae(False), H.port_transformer(),
                                  n_cycles=H.N_CYCLES, max_batch=4,
                                  precision=precision)


def test_sample_tokens_fresh():
    """tests/test_serve.py:111-121: shape, id range, start token
    stripped; the same seed gives the same ids, another seed others."""
    pipe = _pipeline()
    out = pipe.sample_tokens(3, top_k=5, seed=0)
    assert isinstance(out, np.ndarray) and out.shape == (3, H.SEQ_LEN)
    assert (out >= 0).all() and (out < N_CLASSES).all()
    np.testing.assert_array_equal(out, pipe.sample_tokens(3, top_k=5, seed=0))
    assert (out != pipe.sample_tokens(3, top_k=5, seed=1)).any()
    # the ids are generate_kv's from the start token, without it
    start = torch.full((3, 1), pipe.start_token, dtype=torch.int32)
    ref = pipe.tr_model.generate_kv(
        start, do_sample=True, top_k=5,
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out, _np(ref)[:, 1:])


def test_sample_tokens_prompt_and_options():
    pipe = _pipeline("int8")            # the sampler stays f32
    prompt = _prompt("prompt")[0]
    out = pipe.sample_tokens(prompt=prompt, top_k=5, seed=2, num_steps=8)
    assert out.shape == (3, 4 + 8)
    np.testing.assert_array_equal(out[:, :4], prompt)
    assert (out >= 0).all() and (out < N_CLASSES).all()
    fast = pipe.sample_tokens(prompt=prompt, top_k=5, seed=2, num_steps=8,
                              cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, cache_buckets=4)
    assert fast.shape == out.shape
    np.testing.assert_array_equal(fast[:, :4], prompt)
    with pytest.raises(ValueError, match="n .* or prompt"):
        pipe.sample_tokens()
