"""The Mamba language model (dimsum_torch/models/lm.py, eval/lm_harness.py,
utils/hf.py) against the JAX package's (dimsum_tpu/models/lm.py,
eval/lm_harness.py, utils/hf.py) on small configs (d_model 32 and 64, 2
layers, vocab 100 padded to 104), fp32, the JAX side on its XLA scan.
The JAX params (shapes from `jax.eval_shape`, leaves from a numpy seed)
reach the port through `lm_state_dict_from_jax_params` and load strictly.

Checked: the logits (RMSNorm and LayerNorm, the residual in fp32 or not);
`mamba_step` token by token against JAX's and against the port mixer's
own full forward; greedy `generate` token for token, and its first token
against the forward's argmax; `MambaScorer` log-likelihoods and greedy
flags; the HF checkpoint names (a state dict saved as `.bin` and as
`.safetensors` loads strictly, and JAX's own HF converter takes it to the
same logits); the lm_eval entry point's ImportError.

Tolerances: logits and step outputs 1e-5 of their scale (the JAX CPU scan
is associative, the port's sequential: ~1e-7 of scale a layer here); step
against the full forward 1e-5 (the same recurrence, another summation
order); log-likelihood sums 1e-5 relative."""

import math
import runpy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dimsum_tpu.eval.lm_harness import MambaScorer as JaxScorer
from dimsum_tpu.models.lm import MambaLMConfig as JaxLMConfig
from dimsum_tpu.models.lm import MambaLMHeadModel as JaxLM
from dimsum_tpu.models.lm import generate as jax_generate
from dimsum_tpu.models.lm import mamba_step as jax_mamba_step
from dimsum_tpu.utils.hf import convert_hf_mamba_state_dict
from dimsum_torch.eval import lm_harness
from dimsum_torch.eval.lm_harness import MambaScorer
from dimsum_torch.models.lm import (MambaLMConfig, MambaLMHeadModel, build_lm,
                                    generate, mamba_step)
from dimsum_torch.utils.convert import lm_state_dict_from_jax_params
from dimsum_torch.utils.hf import load_hf_mamba
from tests.test_torch_convert import (randomize,  # noqa: F401
                                      torch_one_thread)

VOCAB = 100
TOL = 1e-5


def _assert_scaled(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def lm_pair(d_model=32, n_layer=2, seed=0, **kw):
    """(JAX config, JAX params, port model with the same weights)."""
    jcfg = JaxLMConfig(d_model=d_model, n_layer=n_layer, vocab_size=VOCAB,
                       scan_impl="xla", **kw)
    shapes = jax.eval_shape(JaxLM(jcfg).init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4), jnp.int32))
    params = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    # the norm weights near 1 (randomize gives other leaves 0.1 N(0, 1))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (1 + 0.1 * rng.standard_normal(v.shape)).astype(
            np.float32)
        if str(getattr(p[-1], "key", "")).endswith("norm_weight")
        or str(getattr(p[-1], "key", "")) == "norm_f_weight" else v, params)
    port = MambaLMHeadModel(MambaLMConfig(d_model=d_model, n_layer=n_layer,
                                          vocab_size=VOCAB, **kw))
    port.load_state_dict(lm_state_dict_from_jax_params(params), strict=True)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), port.eval()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


@pytest.mark.parametrize("d_model, kw", [
    (32, {}), (64, {}), (32, dict(rms_norm=False)),
    (32, dict(residual_in_fp32=False))])
def test_lm_logits_match_jax(d_model, kw):
    jcfg, params, port = lm_pair(d_model, **kw)
    ids = _ids(1, (2, 12))
    want = np.asarray(jax.jit(JaxLM(jcfg).apply)(params, ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, 12, 104)
    _assert_scaled(got.numpy(), want, TOL, "logits")


def test_mamba_step_matches_jax_and_the_full_forward():
    """Layer 0's mixer, 10 tokens one at a time from zero states: each
    step's output and states against JAX's `mamba_step` on the same
    params, and the outputs against the mixer's full-sequence forward."""
    jcfg, params, port = lm_pair(32)
    mixer, jp = port.backbone.layers[0].mixer, params["params"]["layers_0"][
        "mixer"]
    B, L, d_inner = 2, 10, 64
    x = np.random.default_rng(2).standard_normal((B, L, 32)).astype(
        np.float32)
    cs, ss = torch.zeros(B, 4, d_inner), torch.zeros(B, d_inner, 16)
    jcs, jss = jnp.zeros((B, 4, d_inner)), jnp.zeros((B, d_inner, 16))
    step = jax.jit(lambda *a: jax_mamba_step(jp, *a, dt_rank=2))
    outs = []
    with torch.no_grad():
        for t in range(L):
            y, cs, ss = mamba_step(mixer, torch.from_numpy(x[:, t]), cs, ss)
            jy, jcs, jss = step(x[:, t], jcs, jss)
            _assert_scaled(y.numpy(), jy, TOL, f"step {t}")
            _assert_scaled(cs.numpy(), jcs, TOL, f"conv_state {t}")
            _assert_scaled(ss.numpy(), jss, TOL, f"ssm_state {t}")
            outs.append(y)
        full = mixer(torch.from_numpy(x))
    _assert_scaled(torch.stack(outs, 1).numpy(), full.numpy(), TOL,
                   "step vs full")
    with pytest.raises(NotImplementedError, match="scan_type"):
        mixer.scan_type = "v2"
        mamba_step(mixer, torch.from_numpy(x[:, 0]), cs, ss)


def test_greedy_generation_matches_jax_token_for_token():
    jcfg, params, port = lm_pair(32)
    ids = _ids(3, (2, 5))
    want = np.asarray(jax_generate(params, jcfg, jnp.asarray(ids), 6,
                                   temperature=0.0))
    tid = torch.from_numpy(ids).long()
    got = generate(port, tid, 6, temperature=0.0)
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        last = port(tid)[:, -1]
    assert torch.equal(got[:, 5], last.argmax(-1))


def test_sampled_generation_draws_from_its_generator():
    """temperature and top_k: the same generator seed gives the same
    tokens, and every drawn token is among the top_k of its step's logits
    (checked through the greedy route at top_k 1)."""
    _, _, port = lm_pair(32)
    ids = torch.from_numpy(_ids(4, (3, 4))).long()

    def draw(seed, **kw):
        return generate(port, ids, 5, generator=torch.Generator()
                        .manual_seed(seed), **kw)

    a, b = draw(7, temperature=0.8, top_k=5), draw(7, temperature=0.8,
                                                   top_k=5)
    assert torch.equal(a, b) and torch.equal(a[:, :4], ids)
    assert torch.equal(draw(1, temperature=1.0, top_k=1),
                       generate(port, ids, 5, temperature=0.0))


def test_scorer_matches_jax():
    jcfg, params, port = lm_pair(32)
    jax_scorer, scorer = JaxScorer(params, jcfg), MambaScorer(port)
    rng = np.random.default_rng(5)
    for n_pre, n_cont in ((7, 3), (30, 10), (1, 1)):
        pre = rng.integers(0, VOCAB, n_pre).tolist()
        cont = rng.integers(0, VOCAB, n_cont).tolist()
        ll, greedy = scorer.loglikelihood(pre, cont)
        want_ll, want_greedy = jax_scorer.loglikelihood(pre, cont)
        assert greedy == want_greedy
        assert abs(ll - want_ll) <= TOL * abs(want_ll)
    toks = rng.integers(0, VOCAB, 20).tolist()
    assert scorer.loglikelihood_rolling(toks) == scorer.loglikelihood(
        toks[:1], toks[1:])[0]
    assert scorer._bucket(5) == 32 and scorer._bucket(33) == 64
    assert MambaScorer(port, max_length=48)._bucket(100) == 48


def test_scorer_greedy_flag_and_greedy_until():
    """A continuation that is the greedy decode scores is_greedy True;
    greedy_until cuts before the first stop token."""
    _, _, port = lm_pair(32)
    scorer = MambaScorer(port)
    prompt = _ids(6, (7,)).tolist()
    new = scorer.greedy_until(prompt, 6)
    assert len(new) == 6
    assert scorer.loglikelihood(prompt, new)[1] is True
    assert scorer.greedy_until(prompt, 6, stop_tokens=[new[2]]) == \
        new[:new.index(new[2])]


def _hf_state_dict(port):
    return {k: v.clone() for k, v in port.state_dict().items()}


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_checkpoint_loads_strictly(fmt, tmp_path):
    """A state dict under the HF names, saved as a file, loads through
    `load_hf_mamba` (config read from the shapes) to the same logits; JAX's
    `convert_hf_mamba_state_dict` takes the same names to the same
    logits."""
    jcfg, params, port = lm_pair(32)
    sd = _hf_state_dict(port)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "bin":
        torch.save(sd, path)
    else:
        safetensors = pytest.importorskip("safetensors.torch")
        safetensors.save_file(sd, path)
    cfg, loaded = load_hf_mamba(path, device="cpu")
    assert (cfg.d_model, cfg.n_layer, cfg.padded_vocab) == (32, 2, 104)
    assert loaded.lm_head.weight is loaded.backbone.embedding.weight
    ids = _ids(7, (1, 9))
    with torch.no_grad():
        got = loaded(torch.from_numpy(ids).long())
        want = port(torch.from_numpy(ids).long())
    assert torch.equal(got, want)
    jparams = {"params": convert_hf_mamba_state_dict(
        {k: v.numpy() for k, v in sd.items()})}
    jcfg = JaxLMConfig(d_model=32, n_layer=2, vocab_size=104,
                       scan_impl="xla")
    _assert_scaled(got.numpy(), np.asarray(JaxLM(jcfg).apply(jparams, ids)),
                   TOL, "logits from JAX's HF converter")


def test_hf_checkpoint_checks_its_tied_head(tmp_path):
    _, _, port = lm_pair(32)
    sd = _hf_state_dict(port)
    del sd["lm_head.weight"]  # left out: taken from the embedding
    torch.save(sd, tmp_path / "tied.bin")
    _, loaded = load_hf_mamba(str(tmp_path / "tied.bin"), device="cpu")
    assert torch.equal(loaded.lm_head.weight, sd[
        "backbone.embedding.weight"])
    sd["lm_head.weight"] = sd["backbone.embedding.weight"] + 1
    torch.save(sd, tmp_path / "untied.bin")
    with pytest.raises(ValueError, match="ties them"):
        load_hf_mamba(str(tmp_path / "untied.bin"), device="cpu")


def test_bf16_model_stores_its_weights_in_bf16():
    cfg = MambaLMConfig(d_model=32, n_layer=2, vocab_size=VOCAB,
                        dtype=torch.bfloat16)
    model = build_lm(cfg, device="cpu", seed=3)
    assert model.backbone.embedding.weight.dtype == torch.bfloat16
    assert model.lm_head.weight is model.backbone.embedding.weight
    assert model.backbone.layers[0].mixer.in_proj.weight.dtype == \
        torch.bfloat16
    assert model.backbone.layers[0].mixer.A_log.dtype == torch.float32
    ids = torch.from_numpy(_ids(8, (2, 6))).long()
    with torch.no_grad():
        logits = model(ids)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    out = generate(model, ids, 3, temperature=0.0)
    assert out.shape == (2, 9)
    assert math.isfinite(MambaScorer(model).loglikelihood([1, 2], [3])[0])


def test_lm_eval_entry_point_without_lm_eval():
    assert lm_harness.MambaEvalWrapper is None
    with pytest.raises(ImportError, match="lm_eval is not installed"):
        runpy.run_module("dimsum_torch.eval.lm_harness", run_name="__main__")
