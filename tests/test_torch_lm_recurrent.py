"""The port's LM serving path against the JAX package's, the recurrent
and encoder-decoder families: hybrid (recurrentgemma-9b: RG-LRU blocks and
sliding-window attention on a ring cache), ssm (rwkv6-1.6b: chunked WKV)
and audio (seamless-m4t-large-v2: encoder, decoder self and cross
caches), at their smoke configs on the CPU; then the serving CLI and
``SyntheticLM``.

Bars: every step's logits within 1e-4 of the JAX step's largest |logit|
for the recurrent families (the RG-LRU's parallel scan combines in
another tree than XLA's ``associative_scan``), 1e-5 for seamless, an
attention family; greedy tokens equal wherever JAX's top-2 gap exceeds
1e-3.  The prompt (20 tokens) is past the hybrid smoke window (16), so
the ring prefill keeps the trailing window and decoding wraps it.
"""

import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro.models import recurrent as jrec
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve
from repro_torch.models import recurrent as trec
from repro_torch.models import steps as TS
import torch_one_thread  # noqa: F401  (one intra-op thread)

BARS = {"recurrentgemma-9b": 1e-4, "rwkv6-1.6b": 1e-4,
        "seamless-m4t-large-v2": 1e-5}


@pytest.fixture(scope="module")
def runs():
    """One JAX/port serving twin per architecture, shared by the tests."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tw.serve_twins(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", list(BARS))
def test_serve_logits_match_jax(arch, runs):
    """Prefill and 8 teacher-forced decode steps within the family's bar
    of JAX's largest |logit|."""
    tw.check_logits(runs(arch), BARS[arch])


@pytest.mark.parametrize("arch", list(BARS))
def test_serve_greedy_tokens_match_jax(arch, runs):
    """The argmax of every step equals JAX's where JAX's top-2 gap exceeds
    1e-3 (and most steps have such a gap)."""
    held = tw.check_greedy(runs(arch))
    assert held >= (tw.G + 1) * tw.B // 2, held


@pytest.mark.parametrize("arch", list(BARS))
def test_decode_matches_forward(arch):
    """prefill(S) + decode(1) == forward(S+1) at the last position, within
    the family's bar of the largest |logit| (S = 32, past the window)."""
    cfg, model, _, _ = tw.port_model(arch, seed=3)
    err, scale = tw.decode_vs_forward(cfg, model, seed=4)
    assert err <= BARS[arch] * scale, (err, scale)


def test_sliding_window_ring_matches_dense_mask():
    """Ring-buffer decode == windowed attention over the whole sequence:
    a prompt of window + 8 tokens, then 8 decode steps that keep wrapping
    the ring, each against forward over the tokens so far (1e-4 of the
    largest |logit|)."""
    cfg, model, _, _ = tw.port_model("recurrentgemma-9b", seed=5)
    w = cfg.window
    toks = torch.from_numpy(tw.np_inputs(cfg, 6, w + 16)["tokens"]).long()
    s = w + 8
    _, caches = TS.model_module(cfg).prefill(cfg, model, toks[:, :s],
                                              cache_len=w + 16)
    ring = caches[2]                       # the first attention block's
    assert ring["k"].shape[1] == w
    assert sorted(ring["pos"].tolist()) == list(range(s - w, s))
    for t in range(s, w + 16):
        ld, caches = TS.model_module(cfg).decode_step(
            cfg, model, toks[:, t:t + 1], t, caches)
        full, _ = TS.model_module(cfg).forward(cfg, model, toks[:, :t + 1])
        err = float((full[:, -1] - ld[:, 0]).abs().max())
        assert err <= 1e-4 * float(full[:, -1].abs().max()), (t, err)
    assert sorted(caches[2]["pos"].tolist()) == list(range(w, w + 16))


def _wkv_sequential(r, k, v, w, u, s0):
    S, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, ..., :, None] * S + kv
    return S, torch.stack(ys, dim=1)


@pytest.mark.parametrize("s", [48, 130])
def test_chunked_wkv_matches_sequential(s):
    """The port's chunked WKV (3 chunks of 16 at S = 48; 65 chunks of 2 at
    S = 130) against the token-by-token recurrence, 1e-4 max-abs as JAX's
    test; the chunk size is JAX's for every S up to 4096."""
    g = torch.Generator().manual_seed(7)
    b, h, d = 2, 4, 16
    r, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, s, h, d, generator=g) - 3.0))
    u = 0.1 * torch.randn(h, d, generator=g)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g)
    s1, y1 = _wkv_sequential(r, k, v, w, u, s0)
    s2, y2 = trec._wkv_chunked(r, k, v, w, u, s0)
    assert float((y1 - y2).abs().max()) < 1e-4
    assert float((s1 - s2).abs().max()) < 1e-4
    assert all(trec._wkv_chunk_size(n) == jrec._wkv_chunk_size(n)
               for n in range(1, 4097))


def test_linear_scan_matches_sequential():
    """The RG-LRU's log-depth scan against h_t = a_t h_{t-1} + b_t over
    2112 steps (the card's hybrid prompt), 1e-5 of the largest |h|."""
    g = torch.Generator().manual_seed(8)
    a = torch.rand(2, 2112, 8, generator=g) * 0.1 + 0.9
    b = torch.randn(2, 2112, 8, generator=g)
    h, hs = torch.zeros(2, 8), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    ref = torch.stack(hs, dim=1)
    err = float((trec._linear_scan(a, b) - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_init_laws_match_jax(arch):
    """The port's init draws from JAX's laws (tests/torch_lm_twins.py::
    init_laws_match): the RG-LRU's Λ formula, gates and conv, RWKV's
    mixes, base decay, LoRA and bonus, the encoder and decoder stacks."""
    assert tw.init_laws_match(arch) >= 19


@pytest.mark.parametrize("arch", tconfigs.all_arch_names())
def test_cli_serves_every_arch_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <a> --device cpu``
    serves every architecture at its smoke config: the JAX launcher's
    printout, tokens in the vocabulary, and the same tokens again from
    the same seed."""
    argv = ["--arch", arch, "--device", "cpu", "--requests", "2",
            "--prompt-len", "8", "--gen", "3"]
    out = serve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] arch=")
    assert "ms/token" in lines[1] and "continuations" in lines[2]
    cfg = tconfigs.get_smoke(arch)
    assert out["tokens"].shape == (2, 3)
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert bool(torch.isfinite(out["last_logits"]).all())
    assert out["peak_bytes"] is None        # not measured on the CPU
    assert torch.equal(serve.main(argv)["tokens"], out["tokens"])


def test_cli_default_device_is_the_card():
    """Without ``--device`` the launcher asks for the card, and here,
    without one, it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-1.6b"])


def test_synthetic_lm_zipf_tokens_are_the_inverse_cdf_of_uniforms(
        monkeypatch):
    """zipf tokens are the inverse CDF of the unigram law (float64, on
    the host) at the batch generator's uniforms: a counter-based stream
    that gives the same tokens on every draw on a card too.
    ``torch.multinomial``, which drew other tokens on every call on a
    card, is not called."""
    def refuse(*a, **k):
        raise AssertionError("torch.multinomial called")

    monkeypatch.setattr(torch, "multinomial", refuse)
    cfg = tconfigs.get_smoke("glm4-9b")
    data = SyntheticLM(cfg, batch=3, seq_len=40, seed=5, device="cpu")
    got = data.batch_at(4)["tokens"]
    u = torch.rand((3, 40), generator=data._generator(4),
                   dtype=torch.float64).numpy()
    p = (1.0 + np.arange(cfg.vocab_size)) ** -1.2
    want = np.searchsorted(np.cumsum(p / p.sum()), u, side="right")
    assert np.array_equal(got.numpy(), np.minimum(want, cfg.vocab_size - 1))


def test_synthetic_lm_deterministic():
    """Batch i is a pure function of (seed, i): equal on a second draw and
    from a fresh instance, different across steps and seeds; the family's
    frames / prefix embeddings have their shapes; zipf tokens skew to the
    low ids, uniform tokens span the vocabulary."""
    for arch in ("glm4-9b", "pixtral-12b", "seamless-m4t-large-v2"):
        cfg = tconfigs.get_smoke(arch)
        data = SyntheticLM(cfg, batch=3, seq_len=24, seed=11, device="cpu")
        a, b = data.batch_at(2), data.batch_at(2)
        c = SyntheticLM(cfg, batch=3, seq_len=24, seed=11,
                        device="cpu").batch_at(2)
        for k in a:
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
        assert not torch.equal(a["tokens"], data.batch_at(3)["tokens"])
        assert not torch.equal(
            a["tokens"], SyntheticLM(cfg, 3, 24, seed=12,
                                     device="cpu").batch_at(2)["tokens"])
        if cfg.is_encdec:
            assert a["frames"].shape == (3, 24, cfg.d_model)
        elif cfg.num_prefix_embeds:
            assert a["tokens"].shape == (3, 24 - cfg.num_prefix_embeds)
            assert a["prefix_embeds"].shape == (3, cfg.num_prefix_embeds,
                                                cfg.d_model)
        else:
            assert set(a) == {"tokens"} and a["tokens"].shape == (3, 24)
    cfg = tconfigs.get_smoke("glm4-9b")
    zipf = SyntheticLM(cfg, 4, 512, device="cpu").batch_at(0)["tokens"]
    uni = SyntheticLM(cfg, 4, 512, mode="uniform",
                      device="cpu").batch_at(0)["tokens"]
    assert np.median(zipf.numpy()) < 0.1 * cfg.vocab_size
    assert int(uni.min()) >= 0 and int(uni.max()) < cfg.vocab_size
    assert np.median(uni.numpy()) > 0.3 * cfg.vocab_size
