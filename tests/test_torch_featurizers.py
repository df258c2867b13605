"""The port's featurizers against the JAX package and the Hugging Face torch
models, on the CPU, at small widths with seeded weights (no downloads).

* Towers: BERT (last hidden state on valid tokens, the last-four sum, the
  masked mean) and CLIP text at atol 2e-5, CLIP vision at 3e-5 -- the JAX
  package's tolerances (tests/test_text_encoders.py:62,82,98,140,253) --
  each against the flax tower with weights converted from the HF model and
  against the HF model itself.  ResNet-50 against the flax ResNet50 on one
  torchvision-layout state dict (eval mode, random running statistics)
  within 2^-15 of the output's largest value, the generators' raw-output
  rule (PERF.md section 2); the JAX package holds its ResNet to no number.
* ``convert.*_state_dict``: flax variables -> the port's keys, loaded
  strictly, the same outputs as the flax tower.
* The snapshot reader against ``AutoModel.from_pretrained(...).state_dict()``
  bit for bit (safetensors in F32, F16 and BF16, and ``.bin``).
* Both tokenizers against ``BertTokenizer`` / ``CLIPTokenizer`` on
  vocabularies the test writes: ids and masks equal.
* ``data/text`` and ``data/video`` against the JAX package's
  ``weights_path`` routes on snapshots written by ``transformers``.
* ``clip_preprocess``: the normalized input against a float64 evaluation
  of the JAX package's resize at 1e-5 (and closer to it than the JAX
  package's own, whose CPU einsum is farther than that), the resized image
  against the JAX package's at 1e-5.
"""

import json
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # every snapshot here is local

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402
from jax._src.image import scale as jax_scale  # noqa: E402

from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (  # noqa: E402
    text as j_text,
    video as j_video,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (  # noqa: E402
    clip_vision as j_clip_vision,
    resnet as j_resnet,
    text_encoders as j_text_encoders,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (  # noqa: E402
    synthetic,
    text,
    tokenizers,
    video,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (  # noqa: E402
    clip_vision,
    convert,
    hf_snapshot,
    resnet,
    text_encoders,
)

TEXT_ATOL = 2e-5
VISION_ATOL = 3e-5
RESNET_REL = 2.0**-15
PRE_ATOL = 1e-5

# How2Sign-style sentences with accents, digits, contractions and punctuation
SENTENCES = [
    "Hello world, this is sign language!",
    "Don't you think it's GREAT? We'll see... I'm sure they've won.",
    "Café résumé naïve — über 2023 numbers: 3.14, 1,000 and ½ ²",
    "How2Sign: (ASL) \"quoted\" text; with 'single' quotes & ampersands/slashes",
    "tabs\tand\nnewlines  and   spaces",
    "a" * 120 + " long word",
    "I'M SHOUTING THAT'S IT'LL BE OK'S",
    "emoji 😀 here ✓ and İstanbul ﬁnance",
    "hello [SEP] world [MASK]x <|endoftext|> inside",
    "unknownword zzz qqqq",
    "",
    "a sentence longer than the truncation " * 12,
]
CJK = "中文字符 and 日本語 mixed with English"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Under six test workers torch's CPU threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _build(make, sd):
    return text_encoders.materialize(make, "cpu", state_dict=sd)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert_trio():
    cfg = transformers.BertConfig(
        vocab_size=211, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(cfg).eval()  # with its pooler: bert_state drops it
    sd = hf.state_dict()
    port = _build(lambda: text_encoders.BertEncoder(
        **text_encoders.bert_config_from_state(sd, num_heads=4)), text_encoders.bert_state(sd))
    flax = j_text_encoders.BertEncoder(**j_text_encoders.bert_config_from_state(_np(sd), 4))
    return hf, port, (flax, j_text_encoders.bert_from_hf_state(_np(sd)))


def _bert_outputs(kind, model, ids, mask):
    """(last hidden, last-four sum, masked mean) of a BERT tower."""
    if kind == "hf":
        with torch.no_grad():
            hs = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                       output_hidden_states=True).hidden_states
        last, four = hs[-1], sum(hs[-4:])
        return last.numpy(), four.numpy(), text_encoders.bert_mean_pool(
            last, torch.from_numpy(mask)).numpy()
    if kind == "port":
        with torch.no_grad():
            last, hs = model(torch.from_numpy(ids), torch.from_numpy(mask),
                             output_hidden_states=True)
        return last.numpy(), sum(hs[-4:]).numpy(), text_encoders.bert_mean_pool(
            last, torch.from_numpy(mask)).numpy()
    flax, variables = model
    last, hs = flax.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                          output_hidden_states=True)
    return (np.asarray(last), np.asarray(sum(hs[-4:])),
            np.asarray(j_text_encoders.bert_mean_pool(last, jnp.asarray(mask))))


@pytest.mark.parametrize("output", ["last_hidden", "last_four_sum", "mean_pool"])
def test_bert_matches_flax_and_hf(bert_trio, rng, output):
    """Masked positions count only in the mean pool (as in the JAX test, a
    consumer masks them; HF's finfo.min bias and -1e9 differ there)."""
    hf, port, flax = bert_trio
    ids = rng.randint(0, 211, size=(3, 17))
    mask = np.ones((3, 17), np.int64)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    i = ("last_hidden", "last_four_sum", "mean_pool").index(output)
    got = _bert_outputs("port", port, ids, mask)[i]
    valid = mask.astype(bool) if i < 2 else slice(None)
    for kind, model in (("flax", flax), ("hf", hf)):
        want = _bert_outputs(kind, model, ids, mask)[i]
        np.testing.assert_allclose(got[valid], want[valid], atol=TEXT_ATOL, err_msg=kind)


def test_bert_state_strips_prefix_and_pooler(bert_trio):
    hf, port, _ = bert_trio
    dump = {f"bert.{k}": v for k, v in hf.state_dict().items()}
    dump["cls.predictions.bias"] = torch.zeros(3)
    dump["bert.embeddings.position_ids"] = torch.arange(40)[None]
    sd = text_encoders.bert_state(dump)
    assert sorted(sd) == sorted(port.state_dict())
    with pytest.raises(ValueError, match="positions"):
        port(torch.zeros(1, 41, dtype=torch.int64))


@pytest.fixture(scope="module")
def clip_text_trio():
    cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=19, projection_dim=24,
        eos_token_id=98, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.CLIPTextModelWithProjection(cfg).eval()
    sd = hf.state_dict()
    port = _build(lambda: text_encoders.CLIPTextEncoder(99, 32, 3, 4, 64, 19, 24,
                                                        eos_token_id=98),
                  text_encoders.clip_text_state(sd))
    flax = j_text_encoders.CLIPTextEncoder(vocab_size=99, hidden_size=32, num_layers=3,
                                           num_heads=4, intermediate_size=64,
                                           max_position=19, projection_dim=24,
                                           eos_token_id=98)
    return hf, port, (flax, j_text_encoders.clip_text_from_hf_state(_np(sd)))


def test_clip_text_matches_flax_and_hf(clip_text_trio, rng):
    hf, port, (flax, variables) = clip_text_trio
    ids = rng.randint(0, 98, size=(2, 19))
    ids[0, 7] = 98
    ids[1, 18] = 98
    ids[1, 11] = 98  # pooled at the first EOS
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
        want_hf = hf(torch.from_numpy(ids)).text_embeds.numpy()
    want = np.asarray(flax.apply(variables, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=TEXT_ATOL)
    np.testing.assert_allclose(got, want_hf, atol=TEXT_ATOL)


def test_clip_text_causal_mask(clip_text_trio, rng):
    """Changing the last token leaves every earlier hidden state as it was."""
    _, port, _ = clip_text_trio
    ids = rng.randint(0, 98, size=(1, 19))
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % 98
    with torch.no_grad():
        h1 = port(torch.from_numpy(ids), return_hidden=True)[1]
        h2 = port(torch.from_numpy(ids2), return_hidden=True)[1]
    np.testing.assert_allclose(h1[:, :-1].numpy(), h2[:, :-1].numpy(), atol=1e-6)
    assert not torch.allclose(h1[:, -1], h2[:, -1])


def test_clip_vision_matches_flax_and_hf(rng):
    cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
        image_size=48, patch_size=16, projection_dim=24, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModelWithProjection(cfg).eval()
    sd = hf.state_dict()
    port = _build(lambda: clip_vision.CLIPVisionEncoder(32, 3, 4, 64, 48, 16, 24),
                  clip_vision.clip_vision_state(sd))
    flax = j_clip_vision.CLIPVisionEncoder(hidden_size=32, num_layers=3, num_heads=4,
                                           intermediate_size=64, image_size=48,
                                           patch_size=16, projection_dim=24)
    px = rng.randn(2, 3, 48, 48).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
        want_hf = hf(torch.from_numpy(px)).image_embeds.numpy()
    want = np.asarray(flax.apply(j_clip_vision.clip_vision_from_hf_state(_np(sd)),
                                 jnp.asarray(px.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, want, atol=VISION_ATOL)
    np.testing.assert_allclose(got, want_hf, atol=VISION_ATOL)


@pytest.fixture(scope="module")
def resnet_pth(tmp_path_factory):
    return synthetic.write_resnet50_weights(str(tmp_path_factory.mktemp("rn") / "r.pth"))


def _assert_rel(got, want, rel=RESNET_REL):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_resnet50_matches_flax_on_one_torchvision_state(resnet_pth, rng):
    sd = torch.load(resnet_pth, weights_only=True)
    port = resnet.load_resnet50(resnet_pth, device="cpu")
    assert sorted(port.state_dict()) == sorted(sd)
    x = rng.randn(2, 3, 40, 40).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(j_resnet.ResNet50().apply(j_resnet.from_torchvision_state(_np(sd)),
                                                jnp.asarray(x.transpose(0, 2, 3, 1)), False))
    assert got.shape == (2, 1000)
    _assert_rel(got, want)


def test_resnet50_random_init_is_torchvisions_and_seeded():
    a = resnet.load_resnet50(None, device="cpu")
    b = resnet.load_resnet50(None, device="cpu",
                             generator=torch.Generator().manual_seed(resnet.INIT_SEED))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.conv1.weight.detach()
    assert abs(float(w.std()) - (2.0 / (64 * 49)) ** 0.5) < 0.01
    assert float(a.fc.weight.detach().abs().max()) <= 1.0 / 2048**0.5


@pytest.mark.parametrize("hw", [120, 64, 300])
def test_clip_preprocess_matches_jax(rng, hw):
    """The JAX package's resize weights (``compute_weight_mat``) to the same
    zeros; the normalized input within 1e-5 of a float64 evaluation with
    them, and closer to it than the JAX package's own float32 input (its CPU
    einsum lands ~2e-5 away at 120 -> 224); the resized image within 1e-5 of
    the JAX package's where the crops are (an enlargement), where shrinking
    300 -> 224 its own resize is already farther than that from float64."""
    frames = rng.randint(0, 256, size=(2, hw, hw, 3)).astype(np.uint8)
    got = clip_vision.clip_preprocess(torch.from_numpy(frames.transpose(0, 3, 1, 2)))
    got = got.numpy().transpose(0, 2, 3, 1)
    want = np.asarray(j_clip_vision.clip_preprocess(frames))
    mean, std = j_clip_vision.CLIP_IMAGE_MEAN, j_clip_vision.CLIP_IMAGE_STD
    w = np.asarray(jax_scale.compute_weight_mat(hw, 224, 224 / hw, 0.0,
                                                jax_scale._fill_keys_cubic_kernel, True))
    np.testing.assert_array_equal(clip_vision.cubic_resize_weights(hw, 224) != 0, w != 0)
    exact = np.einsum("thwc,hH,wW->tHWc", frames / 255.0, w.astype(np.float64),
                      w.astype(np.float64), optimize=True)
    exact = (exact - mean) / std
    np.testing.assert_allclose(got, exact, atol=PRE_ATOL)
    assert np.abs(got - exact).max() < np.abs(want - exact).max()
    if hw <= 224:
        np.testing.assert_allclose(got * std + mean, want * std + mean, atol=PRE_ATOL)


# ---------------------------------------------------------------------------
# the weights bridge
# ---------------------------------------------------------------------------


def _flax_tower(name, rng):
    """(flax module, random variables, inputs for flax, inputs for the port,
    port constructor, converter, tolerance)."""
    key = jax.random.PRNGKey(3)
    if name == "bert":
        m = j_text_encoders.BertEncoder(vocab_size=50, hidden_size=32, num_layers=2,
                                        num_heads=4, intermediate_size=64, max_position=16)
        ids = rng.randint(0, 50, size=(2, 9))
        v = m.init(key, jnp.asarray(ids), jnp.ones((2, 9)))
        return (m, v, (jnp.asarray(ids), jnp.ones((2, 9))),
                (torch.from_numpy(ids), torch.ones(2, 9)),
                lambda: text_encoders.BertEncoder(50, 32, 2, 4, 64, 16),
                convert.bert_state_dict, TEXT_ATOL)
    if name == "clip_text":
        m = j_text_encoders.CLIPTextEncoder(vocab_size=50, hidden_size=32, num_layers=2,
                                            num_heads=4, intermediate_size=64,
                                            max_position=12, projection_dim=8, eos_token_id=49)
        ids = rng.randint(0, 49, size=(2, 12))
        ids[:, 6] = 49
        return (m, m.init(key, jnp.asarray(ids)), (jnp.asarray(ids),),
                (torch.from_numpy(ids),),
                lambda: text_encoders.CLIPTextEncoder(50, 32, 2, 4, 64, 12, 8,
                                                      eos_token_id=49),
                convert.clip_text_state_dict, TEXT_ATOL)
    if name == "clip_vision":
        m = j_clip_vision.CLIPVisionEncoder(hidden_size=32, num_layers=2, num_heads=4,
                                            intermediate_size=64, image_size=32,
                                            patch_size=16, projection_dim=8)
        px = rng.randn(2, 32, 32, 3).astype(np.float32)
        return (m, m.init(key, jnp.asarray(px)), (jnp.asarray(px),),
                (torch.from_numpy(px.transpose(0, 3, 1, 2).copy()),),
                lambda: clip_vision.CLIPVisionEncoder(32, 2, 4, 64, 32, 16, 8),
                convert.clip_vision_state_dict, VISION_ATOL)
    m = j_resnet.ResNet50()
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    v = jax.tree.map(np.asarray, m.init(key, jnp.zeros((1, 32, 32, 3)), False))
    r = np.random.RandomState(4)
    v["batch_stats"] = jax.tree.map(
        lambda a: (0.5 + r.rand(*a.shape)).astype(np.float32), v["batch_stats"])
    return (m, v, (jnp.asarray(x), False),
            (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),),
            resnet.ResNet50, convert.resnet50_state_dict, None)


@pytest.mark.parametrize("name", ["bert", "clip_text", "clip_vision", "resnet50"])
def test_bridge_maps_flax_variables_to_the_port(rng, name):
    flax, variables, j_in, t_in, make, bridge, atol = _flax_tower(name, rng)
    sd = bridge(jax.tree.map(np.asarray, variables))
    port = _build(make, sd)  # strict
    with torch.no_grad():
        got = port(*t_in).numpy()
    want = np.asarray(flax.apply(variables, *j_in))
    if atol is None:
        _assert_rel(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol)


# ---------------------------------------------------------------------------
# the snapshot reader
# ---------------------------------------------------------------------------


def _hf_model(kind):
    torch.manual_seed(0)
    if kind == "bert":
        return transformers.BertModel(transformers.BertConfig(
            vocab_size=60, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=24))
    return transformers.CLIPModel(transformers.CLIPConfig.from_text_vision_configs(
        transformers.CLIPTextConfig(vocab_size=49, hidden_size=16, num_hidden_layers=1,
                                    num_attention_heads=2, intermediate_size=32,
                                    max_position_embeddings=8),
        transformers.CLIPVisionConfig(hidden_size=16, num_hidden_layers=1,
                                      num_attention_heads=2, intermediate_size=32,
                                      image_size=32, patch_size=16),
        projection_dim=12))


@pytest.mark.parametrize("kind", ["bert", "clip"])
@pytest.mark.parametrize("fmt", ["F32", "F16", "BF16", "bin"])
def test_snapshot_reader_matches_automodel(tmp_path, kind, fmt):
    dtype = {"F16": torch.float16, "BF16": torch.bfloat16}.get(fmt, torch.float32)
    _hf_model(kind).to(dtype).save_pretrained(str(tmp_path), safe_serialization=fmt != "bin")
    assert os.path.exists(tmp_path / hf_snapshot.WEIGHT_FILES[fmt == "bin"])
    want = transformers.AutoModel.from_pretrained(
        str(tmp_path), local_files_only=True, torch_dtype=dtype).state_dict()
    got = hf_snapshot.read_state(str(tmp_path))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert hf_snapshot.read_config(str(tmp_path))["model_type"] == kind


def test_snapshot_reader_reads_int64_buffers_and_refuses_bad_files(tmp_path):
    """Older dumps keep ``position_ids`` as I64; headers that do not fit the
    file, or name a dtype the reader does not take, raise."""
    from safetensors.torch import save_file

    ok = tmp_path / "ok.safetensors"
    want = {"embeddings.position_ids": torch.arange(12)[None], "w": torch.randn(3, 4)}
    save_file(want, str(ok))
    got = hf_snapshot.read_safetensors(str(ok))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    bad = tmp_path / "model.safetensors"
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="offsets"):
        hf_snapshot.read_safetensors(str(bad))
    header = json.dumps({"w": {"dtype": "I8", "shape": [1], "data_offsets": [0, 1]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(1))
    with pytest.raises(ValueError, match="dtype"):
        hf_snapshot.read_safetensors(str(bad))
    bad.write_bytes((10**6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="exceeds"):
        hf_snapshot.read_safetensors(str(bad))
    with pytest.raises(FileNotFoundError):
        hf_snapshot.read_state(str(tmp_path / "nothing"))


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


def _bert_vocab_file(tmp_path):
    vocab = synthetic.bert_vocab(SENTENCES[:5])
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return vocab, str(path)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("padding", [True, "max_length"])
def test_wordpiece_matches_bert_tokenizer(tmp_path, lower, padding):
    vocab, path = _bert_vocab_file(tmp_path)
    kw = dict(padding=padding, truncation=True, max_length=48 if padding != True else None)
    ref = transformers.BertTokenizer(path, do_lower_case=lower, model_max_length=40)
    ours = tokenizers.WordPieceTokenizer(vocab, do_lower_case=lower, model_max_length=40)
    want = ref(SENTENCES, return_tensors="np", **kw)
    got = ours(SENTENCES, **kw)
    for k in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape[1] == (48 if padding == "max_length" else 40)
    assert ours.tokenize(SENTENCES[0]) == ref.tokenize(SENTENCES[0])


def test_wordpiece_reads_a_saved_tokenizer(tmp_path):
    vocab, path = _bert_vocab_file(tmp_path)
    ref = transformers.BertTokenizer(path, model_max_length=512)
    ref.save_pretrained(str(tmp_path / "saved"))
    ours = tokenizers.WordPieceTokenizer.from_dir(str(tmp_path / "saved"))
    assert ours.model_max_length == 512 and ours.do_lower_case
    np.testing.assert_array_equal(ours(SENTENCES)["input_ids"],
                                  ref(SENTENCES, padding=True, truncation=True,
                                      return_tensors="np")["input_ids"])


@pytest.fixture
def clip_vocab_dir(tmp_path):
    encoder, merges = synthetic.clip_bpe_vocab(SENTENCES + [CJK], n_merges=300)
    (tmp_path / "vocab.json").write_text(json.dumps(encoder))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "".join(
        f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    return str(tmp_path)


@pytest.mark.parametrize("padding", ["max_length", True])
def test_clip_bpe_matches_clip_tokenizer(clip_vocab_dir, padding):
    d = clip_vocab_dir
    ref = transformers.CLIPTokenizer(f"{d}/vocab.json", f"{d}/merges.txt")
    ours = tokenizers.CLIPBPETokenizer.from_dir(d)
    kw = dict(padding=padding, truncation=True, max_length=77 if padding != True else 20)
    sentences = SENTENCES + [CJK]
    want = ref(sentences, return_tensors="np", **kw)
    got = ours(sentences, **kw)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.eos_token_id == ref.eos_token_id == ref.pad_token_id
    assert ours.bos_token_id == ref.bos_token_id


def test_clip_bpe_and_the_fast_tokenizer_differ_only_on_cjk(clip_vocab_dir):
    """``AutoTokenizer`` (the JAX route's) gives ``CLIPTokenizerFast``, whose
    normalizer does not space CJK ideographs as the slow tokenizer's
    BasicTokenizer does; the port follows the slow one."""
    d = clip_vocab_dir
    fast = transformers.CLIPTokenizerFast(f"{d}/vocab.json", f"{d}/merges.txt")
    ours = tokenizers.CLIPBPETokenizer.from_dir(d)
    for s in SENTENCES:
        assert ours.tokenize(s) == fast.tokenize(s), s
    assert ours.tokenize(CJK) != fast.tokenize(CJK)


# ---------------------------------------------------------------------------
# the routes: data/text and data/video against the JAX package's
# ---------------------------------------------------------------------------

ROUTE_SENTENCES = ["Hello world, this is sign language!", "the cat's hat is red.",
                   "Numbers 3 and 44 (again)", "Don't stop; we'll sign more"]


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("text")
    path = d / "train.text.id.en"
    path.write_text("".join(f"clip{i:07d}-{u}-rgb_front {s}\n"
                            for i, s in enumerate(ROUTE_SENTENCES) for u in (1,)))
    ids = [f"clip{i:07d}-1-rgb_front" for i in range(len(ROUTE_SENTENCES))]
    return str(path), ids


@pytest.fixture(scope="module")
def hf_snapshots(tmp_path_factory):
    """A BertModel snapshot (512 positions, for BERTword) and a full CLIPModel
    snapshot, written by transformers (safetensors) with their slow
    tokenizers' files."""
    d = tmp_path_factory.mktemp("snap")
    vocab = synthetic.bert_vocab(ROUTE_SENTENCES)
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d / "bert"))
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=512)).save_pretrained(str(d / "bert"))
    encoder, merges = synthetic.clip_bpe_vocab(ROUTE_SENTENCES, n_merges=120)
    (d / "vocab.json").write_text(json.dumps(encoder))
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    transformers.CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"),
                               model_max_length=77).save_pretrained(str(d / "clip"))
    eos = encoder["<|endoftext|>"]
    cfg = transformers.CLIPConfig.from_text_vision_configs(
        # the JAX route takes hidden // 64 heads
        transformers.CLIPTextConfig(vocab_size=len(encoder), hidden_size=64,
                                    num_hidden_layers=2, num_attention_heads=1,
                                    intermediate_size=64, max_position_embeddings=77,
                                    eos_token_id=eos, bos_token_id=eos - 1, pad_token_id=eos),
        transformers.CLIPVisionConfig(hidden_size=16, num_hidden_layers=2,
                                      num_attention_heads=2, intermediate_size=32,
                                      image_size=32, patch_size=16),
        projection_dim=12)
    transformers.CLIPModel(cfg).save_pretrained(str(d / "clip"))
    return str(d / "bert"), str(d / "clip")


@pytest.mark.parametrize("method", ["BERTsentence", "BERTword", "clip"])
def test_obtain_embeddings_matches_the_jax_route(text_file, hf_snapshots, method):
    path, ids = text_file
    snap = hf_snapshots[method == "clip"]
    got = text.obtain_embeddings(path, ids, method=method, weights_path=snap, device="cpu")
    want = j_text.obtain_embeddings(path, ids, method=method, weights_path=snap)
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.shape[0] == len(ids) and (method != "BERTword" or got.shape[1] == 512)
    np.testing.assert_allclose(got, want, atol=TEXT_ATOL)


def test_obtain_avg_embed_matches_the_jax_route(text_file, hf_snapshots):
    path, ids = text_file
    ids = ids[::-1]  # the route sorts them
    got = text.obtain_avg_embed(path, ids, weights_path=hf_snapshots[0], subset=0.75,
                                device="cpu")
    want = j_text.obtain_avg_embed(path, ids, weights_path=hf_snapshots[0], subset=0.75)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=TEXT_ATOL)


def test_text_routes_refuse_unknown_methods_and_a_missing_card(text_file, hf_snapshots):
    path, ids = text_file
    assert text.obtain_embeddings(path, ids, method="precomputed") is None
    with pytest.raises(ValueError, match="unknown"):
        text.obtain_embeddings(path, ids, method="word2vec", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):  # device defaults to cuda
            text.obtain_embeddings(path, ids, method="BERTsentence",
                                   weights_path=hf_snapshots[0])


def _keypoint_jsons(json_dir, clip_id, centers):
    """One OpenPose JSON a frame with both hands' palm keypoints at the
    given (right, left) centers; None leaves the frame's file out."""
    os.makedirs(json_dir, exist_ok=True)
    for i, c in enumerate(centers):
        if c is None:
            continue
        people = {}
        for hand, (x, y) in zip(("right", "left"), c):
            kp = np.zeros(63)
            kp[0::3], kp[1::3], kp[2::3] = x, y, 0.9
            for j, k in enumerate(video.HAND_KEYPOINT_IDS):  # a spread around the center
                kp[k * 3] += (-6, 2, 3, 1)[j]
                kp[k * 3 + 1] += (1, -4, 2, 1)[j]
            people[f"hand_{hand}_keypoints_2d"] = kp.tolist()
        with open(os.path.join(json_dir, f"{clip_id}_{i:012d}_keypoints.json"), "w") as f:
            json.dump({"people": [people]}, f)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two seeded clips with their keypoint JSONs: centers inside, across
    each border, outside the frame, and a frame without JSON."""
    root = tmp_path_factory.mktemp("kp")
    r = np.random.RandomState(7)
    frames = [r.randint(0, 256, size=(5, 3, 180, 240)).astype(np.uint8),
              r.randint(0, 256, size=(3, 3, 150, 130)).astype(np.uint8)]
    centers = [[((100.4, 90.6), (20.0, 170.0)), ((235.9, 5.2), (-50.0, 40.0)), None,
                ((120.0, 179.5), (400.0, 400.0)), ((60.0, 60.0), (180.5, 100.5))],
               [((64.0, 75.0), (0.0, 0.0)), None, ((129.9, 149.9), (10.5, 140.2))]]
    ids = ["vidA0000001-1-rgb_front", "vidB0000002-3-rgb_front"]
    for sid, c in zip(ids, centers):
        _keypoint_jsons(str(root / sid), sid, c)
    return frames, str(root), ids


@pytest.mark.parametrize("faithful", [False, True])
def test_crop_geometry_matches_jax(clips, faithful):
    frames, root, ids = clips
    got = video.obtain_cropped_clips(frames, root, ids, faithful_first_frame_bug=faithful)
    want = j_video.obtain_cropped_clips(frames, root, ids, faithful_first_frame_bug=faithful)
    for g, w, f in zip(got, want, frames):
        assert g.shape == (f.shape[0], 3, 120, 120, 2) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
        assert (g[1:].any() != faithful) or f.shape[0] == 1
    frame = frames[0][0].transpose(1, 2, 0)
    for center in ((0.0, 0.0), (239.99, 179.99), (-61.0, 10.0), (120.5, 90.5)):
        np.testing.assert_array_equal(video.crop_frame(frame, center),
                                      j_video.crop_frame(frame, center))
    assert video.get_hand_center(None) == j_video.get_hand_center(None) == (700, 700)


def test_resnet_features_match_the_jax_route(clips, resnet_pth):
    frames, root, ids = clips
    crops = video.obtain_cropped_clips(frames, root, ids)
    got = video.obtain_feats_crops_resnet(crops, resnet_pth, batch_size=4, device="cpu")
    want = j_video.obtain_feats_crops_resnet(crops, resnet_pth, batch_size=4)
    for g, w, c in zip(got, want, crops):
        assert g.shape == (c.shape[0], 2000) and g.dtype == np.float32
        _assert_rel(g, w)
    rand = video.obtain_feats_crops_resnet(crops[1:], None, device="cpu")
    assert rand[0].shape == (3, 2000) and np.isfinite(rand[0]).all()


def test_clip_features_match_the_jax_route(clips, hf_snapshots):
    frames, root, ids = clips
    crops = video.obtain_cropped_clips(frames, root, ids)
    got = video.obtain_feats_crops_clip(crops, weights_path=hf_snapshots[1], device="cpu")
    want = j_video.obtain_feats_crops_clip(crops, weights_path=hf_snapshots[1])
    for g, w, c in zip(got, want, crops):
        assert g.shape == (c.shape[0], 24) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=VISION_ATOL)


def test_overlap_vid_points_and_mp4_match_jax(tmp_path, rng):
    vid = rng.randint(0, 256, size=(2, 40, 50, 3)).astype(np.uint8)
    pts = np.array([[10.0, 12.0, 30.0, 44.0], [5.0, 5.0, 39.0, 2.0]])
    np.testing.assert_array_equal(video.overlap_vid_points(vid, pts),
                                  j_video.overlap_vid_points(vid, pts))
    out = video.save_as_mp4(vid.transpose(0, 3, 1, 2), filename=str(tmp_path / "v.avi"))
    assert os.path.getsize(out) > 0
