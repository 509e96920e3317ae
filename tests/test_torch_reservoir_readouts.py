"""The port's enhanced readouts and ESN chatbot (``reservoir.enhanced``,
``reservoir.esn``) against the JAX package's, on the CPU.

- ``MultiLayerReadout`` (JAX + optax there, ``nn.Module`` + Adam here),
  started from JAX's parameters (``convert.mlp_readout_from_jax``): one
  Adam step at the default rate, weights within 1e-6 and predictions within
  1e-6 of their scale; the full 200-epoch fit within MLP_FIT_BAND
  (predictions) and MLP_WEIGHT_BAND; relu, tanh and gelu (tanh
  approximation on both sides).
- ``OnlineLearner`` (SGD, RLS), ``HierarchicalOutput`` and the ESN
  transforms (density mask, leaky integration, noise) are the same numpy
  code: bit-equal on equal inputs and seeds.
- ``EnhancedReservoirRWKV`` end to end on a v7 FP32 synth file (L=2,
  C=256, V=256): within 1e-5 of the scale of JAX's (its activations are
  the ridge reservoir's, ``test_torch_reservoir.py``).
- ``ESNChatbot`` over that file with a byte tokenizer: ``respond``'s
  sampled tokens equal JAX's (same numpy rng seed), personality switches
  and the conversation reset."""

import numpy as np
import pytest
import torch

from rwkv_tpu.models.model import RWKVModel as JaxModel
from rwkv_tpu.reservoir import enhanced as JE
from rwkv_tpu.reservoir import esn as JS
from rwkv_tpu.reservoir import reservoir as JR
from rwkv_tpu_torch.convert import mlp_readout_from_jax
from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.reservoir import enhanced as TE
from rwkv_tpu_torch.reservoir import esn as TS
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf
from test_torch_quant_serve import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (2, 256, 256, 64)  # L, C, V, S
SEQ_LEN = 10
# about twice the worst reading of the 200-epoch fit at rate 1e-2 over
# seeds 0-3, one and two outputs and the three activations, against the
# scale: predictions 2.11e-6, weights 1.74e-4 (relu). Adam's first steps
# move a weight by about the rate whatever its gradient's size, so a
# gradient that float32 sums leave near zero takes them apart.
MLP_FIT_BAND = 5e-6
MLP_WEIGHT_BAND = 4e-4
ACTIVATIONS = ["relu", "tanh", "gelu"]


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def mlp_data(seed: int, n: int = 64, d: int = 24, out: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.tanh(x[:, :out] * 0.7 + x[:, out : 2 * out] * x[:, 2 * out : 3 * out])
    return x, y.astype(np.float32)


def mlp_pair(activation: str, seed: int, d: int = 24, out: int = 1, lr: float = 1e-2):
    """JAX's readout with its initial parameters and the port's carrying
    the same ones."""
    kw = dict(input_size=d, output_size=out, hidden_layers=[32, 16], activation=activation,
              learning_rate=lr, seed=seed)
    jm = JE.MultiLayerReadout(**kw)
    jm._params = jm._init_params()
    tm = TE.MultiLayerReadout(**kw, device="cpu")
    host = [(np.asarray(w), np.asarray(b)) for w, b in jm._params]
    return jm, mlp_readout_from_jax(host, tm)


def weights_rel(jm, tm) -> float:
    return max(max(rel(layer.weight.detach().numpy().T, w), rel(layer.bias.detach().numpy(), b))
               for (w, b), layer in zip(jm._params, tm.layers))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_readout_one_adam_step_matches_jax(activation):
    jm, tm = mlp_pair(activation, seed=0, lr=1e-3)
    x, y = mlp_data(0)
    assert rel(tm.predict(x), jm.predict(x)) <= 1e-6
    jm.fit(x, y, epochs=1)
    tm.fit(x, y, epochs=1)
    for (w, b), layer in zip(jm._params, tm.layers):
        np.testing.assert_allclose(layer.weight.detach().numpy().T, np.asarray(w), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert rel(tm.predict(x), jm.predict(x)) <= 1e-6


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_readout_fit_within_band_of_jax(activation):
    jm, tm = mlp_pair(activation, seed=1, out=2)
    x, y = mlp_data(1, out=2)
    jm.fit(x, y)
    tm.fit(x, y)
    got, ref = tm.predict(x), jm.predict(x)
    assert got.shape == ref.shape == (64, 2)
    assert rel(got, ref) <= MLP_FIT_BAND and weights_rel(jm, tm) <= MLP_WEIGHT_BAND
    # and it learned: the fit is far better than predicting the mean
    assert np.mean((got - y) ** 2) < 0.5 * np.mean((y - y.mean(0)) ** 2)


def test_mlp_readout_initialisation_and_surface():
    """He-normal from a seeded generator: the same seed gives the same
    weights, on any device; dropout is kept and unused; predicting before
    any fit raises; a 1-column output comes back flat."""
    a = TE.MultiLayerReadout(8, hidden_layers=[16], seed=3, dropout=0.5, device="cpu")
    b = TE.MultiLayerReadout(8, hidden_layers=[16], seed=3, device="cpu")
    assert a.dropout == 0.5 and a.hidden_layers == [16]
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight) and not la.bias.any()
    std = float(a.layers[0].weight.detach().std())
    assert 0.3 < std / np.sqrt(2.0 / 8) < 1.7
    assert TE.MultiLayerReadout(8, device="cpu").hidden_layers == [256, 128]
    with pytest.raises(RuntimeError, match="not trained"):
        a.predict(np.zeros((2, 8)))
    a.fit(np.ones((4, 8)), np.ones(4), epochs=2)
    assert a.predict(np.zeros((3, 8))).shape == (3,)
    with pytest.raises(ValueError):
        mlp_readout_from_jax([(np.zeros((8, 4)), np.zeros(4))], b)


@pytest.mark.parametrize("method", ["sgd", "rls"])
def test_online_learner_bit_equal_jax(method):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    y = (x @ rng.standard_normal((6, 2))).astype(np.float32)
    j = JE.OnlineLearner(6, 2, learning_rate=0.05, method=method, seed=2)
    t = TE.OnlineLearner(6, 2, learning_rate=0.05, method=method, seed=2)
    for i in range(0, 30, 3):
        j.update(x[i : i + 3], y[i : i + 3])
        t.update(x[i : i + 3], y[i : i + 3])
    np.testing.assert_array_equal(t.weights, j.weights)
    np.testing.assert_array_equal(t.bias, j.bias)
    np.testing.assert_array_equal(t.predict(x), j.predict(x))


def test_hierarchical_output_bit_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    configs = [
        {"output_size": 1, "time_scale": 1, "readout_type": "ridge",
         "readout_params": {"alpha": 1e-6}},
        {"output_size": 1, "time_scale": 5, "readout_type": "ridge",
         "readout_params": {"alpha": 1e-4}},
        {"output_size": 2, "time_scale": 2, "readout_type": "online",
         "readout_params": {"method": "rls"}},
    ]
    j, t = JE.HierarchicalOutput(8, configs), TE.HierarchicalOutput(8, configs)
    y = {"readout_0_1": x[:, 0], "readout_1_5": x[::5, 1], "readout_2_2": x[::2, :2] * 2}
    j.fit(x, y)
    t.fit(x, y)
    jp, tp = j.predict(x), t.predict(x)
    assert sorted(tp) == sorted(jp) == sorted(y)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    with pytest.raises(ValueError, match="Unknown readout"):
        TE.HierarchicalOutput(8, [{"time_scale": 1, "readout_type": "svm"}])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A v7 FP32 synth file (seed 3): JAX's RWKVModel and the port's on
    the CPU."""
    cfg = synth_config("7.0", *SHAPE)
    path = str(tmp_path_factory.mktemp("readouts") / "v7.bin")
    write_synth_ggmf(cfg, synth_params(cfg, seed=3), path)
    return path, JaxModel(path), RWKVModel(path, device="cpu")


def test_esn_transforms_bit_equal_jax(models):
    """Spectral radius, leaky integration against the previous call's
    array, input scaling, the density mask and the noise (drawn in JAX's
    order from default_rng(random_seed)), bias; a persona overrides the
    constructor's values."""
    _, jm, tm = models
    kw = dict(units=16, leaking_rate=0.6, density=0.4, bias_scaling=0.2, noise_scaling=0.03,
              random_seed=7, persona_type="none")
    j, t = JE.EnhancedReservoirRWKV(jm, **kw), TE.EnhancedReservoirRWKV(tm, **kw)
    acts = np.random.default_rng(8).standard_normal((SEQ_LEN, 16)).astype(np.float32)
    for step in range(3):
        a = acts * (step + 1)
        got, ref = t._apply_esn_transformations(a), j._apply_esn_transformations(a)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t._apply_esn_transformations(acts[:4]),
                                  j._apply_esn_transformations(acts[:4]))
    creative = TE.EnhancedReservoirRWKV(tm, units=8, persona_type="creative", density=0.9)
    assert creative.density == TE.PERSONA_PRESETS["creative"]["density"]
    creative.set_persona("conservative")
    assert creative.spectral_radius == 0.7 and creative.leaking_rate == 0.3


def _task(seed: int):
    rng = np.random.default_rng(seed)
    xs = [list(rng.integers(0, SHAPE[2], size=SEQ_LEN)) for _ in range(4)]
    return xs, np.array([[x[-1] / 255.0] for x in xs], dtype=np.float32)


def _enhanced_pair(models, scan, **kw):
    _, jm, tm = models
    j = JE.EnhancedReservoirRWKV(jm, **kw)
    j._scan_fn = scan
    return j, TE.EnhancedReservoirRWKV(tm, **kw)


@pytest.fixture(scope="module")
def scan(models):
    """JAX's compiled reservoir scan of the file, shared by its instances."""
    return JR.ReservoirRWKV(models[1])._build_scan()


@pytest.mark.parametrize("readout", ["online", "hierarchical", "mlp"])
def test_enhanced_reservoir_fit_predict_within_band_of_jax(models, scan, readout):
    """The persona's leaky integration, density mask and noise on each
    side's own activations; MLP trained from JAX's start."""
    kw = dict(units=16, readout_type=readout, persona_type="balanced",
              readout_config={"hidden_layers": [16], "method": "rls"})
    j, t = _enhanced_pair(models, scan, **kw)
    if readout == "mlp":
        j.custom_readout._params = j.custom_readout._init_params()
        mlp_readout_from_jax([(np.asarray(w), np.asarray(b)) for w, b in j.custom_readout._params],
                             t.custom_readout)
        assert t.custom_readout.device == torch.device("cpu")
    xs, ys = _task(0)
    j.fit(xs, ys, warmup=1)
    t.fit(xs, ys, warmup=1)
    jp, tp = j.predict(xs[1]), t.predict(xs[1])
    if readout == "hierarchical":
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert rel(tp[k], jp[k]) <= 1e-5, k
    else:
        assert rel(tp, jp) <= (MLP_FIT_BAND if readout == "mlp" else 1e-5)


def test_hierarchical_only_fit_does_not_reset_between_sequences(models, scan):
    """y=None with per-readout targets: the activations of all sequences
    are collected without a reset between them (the state and the leaky
    integration carry on), as in JAX."""
    j, t = _enhanced_pair(models, scan, units=16, readout_type="hierarchical",
                          persona_type="conservative")
    xs, _ = _task(1)
    n = len(xs) * SEQ_LEN
    targets = {"readout_0_1": np.linspace(0, 1, n), "readout_1_5": np.linspace(1, 0, n // 5)}
    j.fit(xs, None, hierarchical_targets=targets)
    t.fit(xs, None, hierarchical_targets=targets)
    jp, tp = j.predict(xs[0]), t.predict(xs[0])
    assert sorted(tp) == sorted(jp) == sorted(targets)
    for k in jp:
        assert rel(tp[k], jp[k]) <= 1e-5, k
    t.reset_state()
    assert t._prev_activations is None and t._reservoir_state is None


def test_online_update_and_chatbot_reservoir(models, scan):
    j = JE.create_chatbot_reservoir(models[1], units=16)
    j._scan_fn = scan
    t = TE.create_chatbot_reservoir(models[2], units=16)
    assert t.readout_type == "hierarchical" and t.online_learner is not None
    xs, ys = _task(2)
    j.fit(xs, ys)
    t.fit(xs, ys)
    j.update_online(xs[0], ys[0])
    t.update_online(xs[0], ys[0])
    assert rel(t.online_learner.weights, j.online_learner.weights) <= 1e-5
    assert len(t.batch_predict(xs[:2])) == 2


def test_misspelt_keywords_raise(models):
    """Unknown keywords raise instead of being dropped, so that a misspelt
    `device` cannot send a model or a readout to the card."""
    with pytest.raises(TypeError, match="devcie"):
        TE.MultiLayerReadout(8, devcie="cpu")
    with pytest.raises(TypeError, match="devcie"):
        TE.ReservoirRWKV(models[2], units=16, devcie="cpu")
    with pytest.raises(TypeError, match="devcie"):
        TE.create_chatbot_reservoir(models[2], units=16, devcie="cpu")
    with pytest.raises(TypeError, match="hidden_layer"):
        TE.EnhancedReservoirRWKV(models[2], units=16, readout_type="hierarchical",
                                 hierarchical_configs=[{
                                     "time_scale": 1, "readout_type": "mlp",
                                     "readout_params": {"hidden_layer": [8]}}])


def _byte_codec():
    encode = lambda s: list(s.encode("utf-8"))  # noqa: E731
    decode = lambda toks: bytes(int(x) % 256 for x in toks).decode("latin-1")  # noqa: E731
    return encode, decode


def test_esn_chatbot_respond_matches_jax(models):
    _, jm, tm = models
    j = JS.create_chatbot_esn(jm, personality="creative", seed=0)
    t = TS.create_chatbot_esn(tm, personality="creative", seed=0)
    assert t.get_personality() == "creative" and t.config == TS.esn_create_config("creative")
    encode, decode = _byte_codec()
    jr, tr = j.respond("Hello", encode, decode, max_tokens=16), \
        t.respond("Hello", encode, decode, max_tokens=16)
    assert t.conversation.history_tokens == j.conversation.history_tokens
    assert tr == jr and t.conversation.turn_count == 1
    t.switch_personality("conservative")
    assert t.config.spectral_radius == 0.7 and t.reservoir.spectral_radius == 0.7
    assert t._sampling_params() == {"temperature": 0.7, "top_p": 0.5}
    with pytest.raises(ValueError, match="Unknown personality"):
        t.switch_personality("grumpy")
    t.reset_conversation()
    assert t.conversation.turn_count == 0 and t._chat_state is None
    assert t.conversation.personality == "conservative"
