"""HF conversion (models/llama/hf.py, tools/convert_hf.py, tools/export_hf.py,
tools/inspect_ckpt.py) and the safetensors layout (ckpt/tensor_io.py) of the
port, against the JAX package's converter and exporter and the safetensors
package.

Every HF directory is built inside the test; nothing is downloaded. The
routes between the packages go through HF files in fp32, so parameters are
held bit for bit; logits of a warm-started run are held to the reference's
forward within LOGIT_TOL (fp32 forward through 4 layers: matmul summation
order differs between XLA and PyTorch's CPU kernels).
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama import hf as t_hf
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.tools import convert_hf, export_hf, inspect_ckpt
from llama_pipeline_parallel_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="session")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed on the CPU)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"ckpt": "llama_pipeline_parallel_tpu.ckpt.checkpoint",
            "config": "llama_pipeline_parallel_tpu.models.llama.config",
            "manifest": "llama_pipeline_parallel_tpu.models.llama.manifest",
            "llama": "llama_pipeline_parallel_tpu.models.llama.model",
            "hf": "llama_pipeline_parallel_tpu.models.llama.hf",
            "pl": "llama_pipeline_parallel_tpu.parallel.pipeline"}
    return types.SimpleNamespace(**{k: importlib.import_module(v) for k, v in mods.items()})


@pytest.fixture()
def offline(monkeypatch):
    """transformers reads local directories only: no hub lookups."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    try:
        import huggingface_hub.constants as hub
    except ImportError:
        return
    monkeypatch.setattr(hub, "HF_HUB_OFFLINE", True)


def _port_checkpoint(root, seed=0):
    """A module-only checkpoint-0 of the port at tiny, with its params."""
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, seed, device="cpu")
    t_ckpt.CheckpointManager(str(root)).save(
        0, params, TManifest(num_layers=cfg.num_hidden_layers, num_stages=1), cfg)
    return cfg, params


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# the safetensors layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_files_interop_with_the_package(tmp_path, dtype):
    """Files the port writes open with safetensors.{torch,numpy}.load_file,
    and files the package writes open in the port, with their metadata."""
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy = pytest.importorskip("safetensors.numpy")
    g = torch.Generator().manual_seed(1)
    tensors = {"w": torch.randn(5, 7, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "scalar": torch.randn((), generator=g).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype),
               "count": torch.tensor(7, dtype=torch.int64),
               "ids": torch.arange(5, dtype=torch.int32)}
    ours = str(tmp_path / "ours.safetensors")
    nbytes = tensor_io.write_file(ours, tensors, metadata={"format": "pt"})
    assert nbytes == os.path.getsize(ours)
    got = st_torch.load_file(ours)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if dtype != torch.bfloat16:  # numpy has no bf16
        got_np = st_numpy.load_file(ours)
        for k, v in tensors.items():
            np.testing.assert_array_equal(got_np[k], v.numpy())
    theirs = str(tmp_path / "theirs.safetensors")
    st_torch.save_file(tensors, theirs, metadata={"who": "package"})
    with tensor_io.TensorFile(theirs) as f:
        assert f.metadata == {"who": "package"} and set(f.keys()) == set(tensors)
        for k, v in tensors.items():
            assert f.dtype(k) == v.dtype and f.shape(k) == tuple(v.shape)
            assert torch.equal(f.tensor(k), v), k
    for k, v in tensor_io.load_file(theirs).items():
        assert torch.equal(v, tensors[k]), k


def test_tensor_file_refuses_what_does_not_fit(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="too short"):
        tensor_io.TensorFile(str(bad))
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(12))
    with pytest.raises(ValueError, match="do not fit"):
        tensor_io.TensorFile(str(bad))
    header = json.dumps({"w": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="F64"):
        tensor_io.TensorFile(str(bad))
    with pytest.raises(ValueError, match="dtype"):
        tensor_io.write_file(str(bad), {"x": torch.zeros(2, dtype=torch.float64)})


# ---------------------------------------------------------------------------
# the in-memory mapping and the config
# ---------------------------------------------------------------------------

def _hf_state_dict(cfg, dtype, seed=0, with_head=True):
    rng = np.random.RandomState(seed)
    d, f, v, kv = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.kv_heads * cfg.head_dim

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)

    sd = {"model.embed_tokens.weight": t(v, d), "model.norm.weight": t(d)}
    if with_head:
        sd["lm_head.weight"] = t(v, d)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": t(d, d), p + "self_attn.k_proj.weight": t(kv, d),
                   p + "self_attn.v_proj.weight": t(kv, d), p + "self_attn.o_proj.weight": t(d, d),
                   p + "mlp.gate_proj.weight": t(f, d), p + "mlp.up_proj.weight": t(f, d),
                   p + "mlp.down_proj.weight": t(d, f), p + "input_layernorm.weight": t(d),
                   p + "post_attention_layernorm.weight": t(d)})
    return sd


@pytest.mark.parametrize("dtype,tie", [(torch.float32, False), (torch.bfloat16, False),
                                       (torch.float32, True)])
def test_hf_mapping_matches_reference(ref, dtype, tie):
    """params_from_hf_state_dict and hf_state_dict_from_params give the
    reference's values exactly (every projection transposed, norms not,
    widened to fp32); lm_head follows tie_word_embeddings, and an untied
    config without lm_head is refused, as the reference refuses."""
    rcfg = ref.config.LlamaConfig.tiny(tie_word_embeddings=tie)
    tcfg = TConfig.tiny(tie_word_embeddings=tie)
    sd = _hf_state_dict(tcfg, dtype, with_head=not tie)
    got = t_hf.params_from_hf_state_dict(sd, tcfg)
    _assert_params_equal(got, convert.params_from_jax(ref.hf.params_from_hf_state_dict(sd, rcfg)))
    assert {k: tuple(v.shape) for k, v in got.items()} == t_llama.param_shapes(tcfg)
    want_back = ref.hf.hf_state_dict_from_params(convert.params_to_jax(got), rcfg)
    back = t_hf.hf_state_dict_from_params(got, tcfg)
    assert set(back) == set(want_back)
    for k, v in want_back.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    if tie:
        with pytest.raises(KeyError, match="refusing to silently tie"):
            t_hf.params_from_hf_state_dict(sd, TConfig.tiny())


def test_from_hf_config_matches_reference(ref):
    transformers = pytest.importorskip("transformers")
    for kw in (dict(), dict(num_key_value_heads=2, rope_theta=5e5, tie_word_embeddings=True)):
        hf = transformers.LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=3, num_attention_heads=4,
                                      max_position_embeddings=40, rms_norm_eps=1e-5, **kw)
        want = ref.config.LlamaConfig.from_hf_config(hf)
        for got in (TConfig.from_hf_config(hf), TConfig.from_hf_config(hf.to_dict())):
            for field in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                          "num_attention_heads", "num_key_value_heads",
                          "max_position_embeddings", "rms_norm_eps", "rope_theta",
                          "tie_word_embeddings"):
                assert getattr(got, field) == getattr(want, field), field
    minimal = {"vocab_size": 96, "hidden_size": 32, "intermediate_size": 64,
               "num_hidden_layers": 3, "num_attention_heads": 4,
               "max_position_embeddings": 40, "rms_norm_eps": 1e-5}
    got = TConfig.from_hf_config(minimal)
    assert (got.num_key_value_heads, got.rope_theta, got.tie_word_embeddings) == \
        (None, 10000.0, False)


# ---------------------------------------------------------------------------
# the routes between the packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_to_hf_to_port_warm_start(ref, tmp_path, offline):
    """The reference saves a module-only checkpoint, its export_hf writes
    HF, the port's convert_hf converts it, and a port run with
    model_name_or_path warm-starts from it: params bit-equal, logits within
    LOGIT_TOL of the reference's forward."""
    pytest.importorskip("transformers")
    rcfg = ref.config.LlamaConfig.tiny()
    rman = ref.manifest.StageManifest.for_config(rcfg, 1)
    tree = ref.llama.init_params(jax.random.PRNGKey(3), rcfg)
    ref.ckpt.CheckpointManager(str(tmp_path / "jax")).save(
        0, ref.pl.stack_stages(tree, rman), rman, rcfg)
    importlib.import_module("tools.export_hf").export(str(tmp_path / "jax"), str(tmp_path / "hf"))
    convert_hf.convert(str(tmp_path / "hf"), str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["checkpoint-0", "config.json", "latest"]
    cfg = t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}/run",
        f"model_name_or_path={tmp_path}/port"])
    run = t_train.build_run(cfg, "cpu")
    assert run.start_step == 0
    _assert_params_equal(run.state.params, convert.params_from_jax(jax.device_get(tree)))
    ids = np.random.RandomState(0).randint(0, rcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = ref.llama.forward(tree, jnp.asarray(ids), cfg=rcfg)
    with torch.no_grad():
        got = t_llama.forward(run.state.params, torch.from_numpy(ids), cfg=run.model_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    summary = t_train.train_run(run)  # and it trains from there
    assert np.isfinite(summary["losses"]).all()


def test_port_checkpoint_to_hf_to_jax_is_bit_equal(ref, tmp_path, offline):
    """The port's export_hf writes HF, the reference's convert_hf converts
    it, and the reference's load_module_checkpoint gives the port's params
    bit for bit (fp32)."""
    pytest.importorskip("transformers")
    cfg, params = _port_checkpoint(tmp_path / "port", seed=5)
    export_hf.export(str(tmp_path / "port"), str(tmp_path / "hf"))
    assert json.load(open(tmp_path / "hf" / "config.json"))["model_type"] == "llama"
    importlib.import_module("tools.convert_hf").convert(str(tmp_path / "hf"),
                                                        str(tmp_path / "jax"),
                                                        expand_vocab=False)
    tree, rcfg, _, step = ref.ckpt.load_module_checkpoint(str(tmp_path / "jax"))
    assert step == 0 and rcfg.vocab_size == cfg.vocab_size
    got = convert.params_from_jax(jax.device_get(tree))
    _assert_params_equal(got, params)


@pytest.mark.parametrize("layout", ["bin", "bin_sharded", "safetensors_sharded"])
def test_other_hf_layouts_convert_to_the_same_params(tmp_path, layout):
    """`pytorch_model.bin`, its sharded index and sharded safetensors
    convert to the params a single `model.safetensors` gives."""
    cfg, params = _port_checkpoint(tmp_path / "port", seed=2)
    export_hf.export(str(tmp_path / "port"), str(tmp_path / "hf"))
    sd = tensor_io.load_file(str(tmp_path / "hf" / tensor_io.SINGLE_FILE))
    other = tmp_path / layout
    other.mkdir()
    shutil.copy2(tmp_path / "hf" / "config.json", other / "config.json")
    names = sorted(sd)
    halves = {"a": names[: len(names) // 2], "b": names[len(names) // 2:]}
    if layout == "bin":
        torch.save(sd, other / "pytorch_model.bin")
    else:
        ext, index = (("bin", "pytorch_model.bin.index.json") if layout == "bin_sharded"
                      else ("safetensors", tensor_io.INDEX_FILE))
        weight_map = {}
        for part, keys in halves.items():
            shard = f"model-{part}.{ext}"
            if ext == "bin":
                torch.save({k: sd[k] for k in keys}, other / shard)
            else:
                tensor_io.write_file(str(other / shard), {k: sd[k] for k in keys})
            weight_map.update({k: shard for k in keys})
        (other / index).write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    convert_hf.convert(str(other), str(tmp_path / "out"))
    got, got_cfg, _, _ = t_ckpt.load_module_checkpoint(str(tmp_path / "out"), device="cpu")
    _assert_params_equal(got, params)
    assert got_cfg.vocab_size == cfg.vocab_size
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        convert_hf.hf_weights(str(tmp_path))


def test_convert_hf_refuses_vocab_expansion_and_carries_the_tokenizer(tmp_path):
    """Told not to expand the vocabulary (--no_expand_vocab), the converter
    copies the tokenizer files unread and leaves the params as they are;
    export_hf carries the files on. Needs no transformers."""
    _, params = _port_checkpoint(tmp_path / "port")
    export_hf.export(str(tmp_path / "port"), str(tmp_path / "hf"))
    (tmp_path / "hf" / "tokenizer.json").write_text("{}")
    (tmp_path / "hf" / "special_tokens_map.json").write_text("{}")
    convert_hf.convert(str(tmp_path / "hf"), str(tmp_path / "out"), expand_vocab=False)
    _assert_params_equal(t_ckpt.load_module_checkpoint(str(tmp_path / "out"),
                                                       device="cpu")[0], params)
    assert {"tokenizer.json", "special_tokens_map.json", "config.json"} <= \
        set(os.listdir(tmp_path / "out"))
    export_hf.export(str(tmp_path / "out"), str(tmp_path / "hf2"))
    assert {"tokenizer.json", "special_tokens_map.json", "config.json",
            "model.safetensors"} == set(os.listdir(tmp_path / "hf2"))


def test_convert_hf_skips_the_expansion_without_a_loadable_tokenizer(tmp_path, capsys):
    """With tokenizer files that load as no tokenizer, the converter skips
    the vocabulary expansion with a warning (as the JAX converter does),
    leaves the params as they are and copies the files."""
    pytest.importorskip("transformers")
    _, params = _port_checkpoint(tmp_path / "port")
    export_hf.export(str(tmp_path / "port"), str(tmp_path / "hf"))
    (tmp_path / "hf" / "tokenizer.json").write_text("{}")
    (tmp_path / "hf" / "special_tokens_map.json").write_text("{}")
    convert_hf.convert(str(tmp_path / "hf"), str(tmp_path / "skipped"))
    assert "no loadable tokenizer" in capsys.readouterr().err
    _assert_params_equal(t_ckpt.load_module_checkpoint(str(tmp_path / "skipped"),
                                                       device="cpu")[0], params)
    assert {"tokenizer.json", "special_tokens_map.json", "config.json"} <= \
        set(os.listdir(tmp_path / "skipped"))


def _trained_tokenizer(directory) -> int:
    """A SentencePiece-Unigram tokenizer without a pad token, trained here and
    saved to `directory`; returns its length."""
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator(["the quick brown fox jumps over the lazy dog",
                             "pipeline parallelism cuts a model into stages",
                             "what is the capital of france paris is the capital"] * 8,
                            vocab_size=90, unk_token="<unk>",
                            special_tokens=["<unk>", "<s>", "</s>"])
    tok = PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>",
                                  eos_token="</s>", unk_token="<unk>")
    tok.save_pretrained(str(directory))
    return len(tok)


# transformers' resize_token_embeddings, which the JAX converter calls, draws
# each added row from a normal around the old rows' mean with 1e-9 of their
# covariance; the port writes the mean. An added element may differ by up to
# 8 standard deviations of that draw: 8 * sqrt(1e-9) * the column's std
ADDED_ROW_SIGMAS = 8.0


@pytest.mark.parametrize("env,added", [({}, 0), ({"EOS_TOKEN": "<eos_new>"}, 1),
                                       ({"EOS_TOKEN": "<eos_new>", "PAD_TOKEN": "<pad_new>"}, 2)],
                         ids=["no-pad", "eos-override", "eos-and-pad"])
def test_convert_hf_expands_the_vocabulary_as_the_reference(ref, tmp_path, offline, monkeypatch,
                                                            env, added):
    """An HF directory with a trained tokenizer that has no pad token
    converts to the params the root tools/convert_hf.py gives: every tensor
    but the embeddings bit for bit, the embeddings' and lm_head's old rows bit
    for bit, as many added rows as tokens added, within the added rows'
    spread (ADDED_ROW_SIGMAS); the saved tokenizers have the same vocabulary
    and specials, and config.json the new vocab_size."""
    from transformers import AutoTokenizer

    for key in ("BOS_TOKEN", "EOS_TOKEN", "UNK_TOKEN", "PAD_TOKEN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    n_tok = _trained_tokenizer(tmp_path / "hf")
    cfg = TConfig.tiny(vocab_size=n_tok)
    params = t_llama.init_params(cfg, device="cpu", seed=6)
    t_ckpt.CheckpointManager(str(tmp_path / "port")).save(
        0, params, TManifest(num_layers=cfg.num_hidden_layers, num_stages=1), cfg)
    export_hf.export(str(tmp_path / "port"), str(tmp_path / "hf"))
    convert_hf.convert(str(tmp_path / "hf"), str(tmp_path / "got"))
    importlib.import_module("tools.convert_hf").convert(str(tmp_path / "hf"),
                                                        str(tmp_path / "want"))
    got, got_cfg, _, _ = t_ckpt.load_module_checkpoint(str(tmp_path / "got"), device="cpu")
    tree, rcfg, _, _ = ref.ckpt.load_module_checkpoint(str(tmp_path / "want"))
    want = convert.params_from_jax(jax.device_get(tree))
    assert got_cfg.vocab_size == rcfg.vocab_size == n_tok + added
    assert json.load(open(tmp_path / "got" / "config.json"))["vocab_size"] == n_tok + added
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("embed.embedding", "lm_head"):
            rows = 0 if k == "embed.embedding" else 1  # lm_head is [d, V]
            old = v.narrow(rows, 0, n_tok)
            assert torch.equal(got[k].narrow(rows, 0, n_tok), old), k
            assert torch.equal(old, params[k]), k
            spread = ADDED_ROW_SIGMAS * 1e-9 ** 0.5 * params[k].std(dim=rows).max()
            new = got[k].narrow(rows, n_tok, added)
            torch.testing.assert_close(new, v.narrow(rows, n_tok, added), rtol=0,
                                       atol=spread.item(), msg=k)
            mean = params[k].mean(dim=rows, keepdim=True).expand_as(new)
            torch.testing.assert_close(new, mean, rtol=0, atol=1e-8, msg=k)  # summation order
        else:
            assert torch.equal(got[k], v), k
    got_tok = AutoTokenizer.from_pretrained(str(tmp_path / "got"))
    want_tok = AutoTokenizer.from_pretrained(str(tmp_path / "want"))
    assert got_tok.get_vocab() == want_tok.get_vocab() and len(got_tok) == n_tok + added
    for attr in ("bos_token", "eos_token", "unk_token", "pad_token"):
        assert getattr(got_tok, attr) == getattr(want_tok, attr), attr


def test_warm_start_refusals(tmp_path):
    """No checkpoint under model_name_or_path is a FileNotFoundError naming
    the converter; a checkpoint of another shape a ValueError naming
    re-conversion."""
    base = ["mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}/run"]
    path = os.path.join(REPO, "conf", "tiny_smoke.yaml")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="convert_hf"):
        t_train.build_run(t_config.load_config(
            path, base + [f"model_name_or_path={tmp_path}/empty"]), "cpu")
    _port_checkpoint(tmp_path / "port")
    with pytest.raises(ValueError, match="vocab_size: 256 there, 512 here.*re-convert"):
        t_train.build_run(t_config.load_config(
            path, base + [f"model_name_or_path={tmp_path}/port", "model.vocab_size=512"]), "cpu")


# ---------------------------------------------------------------------------
# inspect_ckpt and the command lines
# ---------------------------------------------------------------------------

def test_inspect_ckpt_verify_statuses(tmp_path, capsys):
    """--verify reports OK per file, then MISMATCH, missing-from-meta and
    missing-on-disk, exiting nonzero on anything not OK; an incomplete step
    and --sizes describe themselves."""
    _port_checkpoint(tmp_path)

    def run(*args):
        rc = inspect_ckpt.main([str(tmp_path), *args])
        return rc, json.loads(capsys.readouterr().out)

    rc, out = run("--verify", "--sizes")
    assert rc == 0 and out["verify"]["status"] == "OK"
    assert out["verify"]["files"] == {"params.safetensors": "OK"}
    assert out["checkpoint"]["storage"] == "safetensors"
    assert out["checkpoint"]["optimizer_state"].startswith("none")
    sizes = out["sizes"]
    assert sizes["files"]["params.safetensors"]["bytes"] > 4 * sizes["model"]["param_count"]
    step_dir = tmp_path / "checkpoint-0"
    (step_dir / "stray.bin").write_bytes(b"x")
    with open(step_dir / "params.safetensors", "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x7f")
    rc, out = run("--verify")
    assert rc == 1 and out["verify"]["files"] == {"params.safetensors": "MISMATCH",
                                                 "stray.bin": "missing-from-meta"}
    os.remove(step_dir / "params.safetensors")
    rc, out = run("--verify")
    assert out["verify"]["files"]["params.safetensors"] == "missing-on-disk"
    os.makedirs(tmp_path / "checkpoint-7")
    rc, out = run("--step", "7", "--verify")
    assert rc == 1 and out["verify"]["status"] == "INCOMPLETE"
    assert out["steps"]["7"].startswith("INCOMPLETE")


def test_tools_run_as_modules(tmp_path):
    """python -m ...tools.export_hf / convert_hf / inspect_ckpt, with the
    reference's flags."""
    _, params = _port_checkpoint(tmp_path / "port", seed=4)
    env = dict(os.environ, PYTHONPATH=REPO)

    def tool(name, *args):
        res = subprocess.run([sys.executable, "-m", f"llama_pipeline_parallel_tpu_torch.tools.{name}",
                              *args], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        return res

    res = tool("export_hf", "--checkpoint_dir", str(tmp_path / "port"),
               "--output_dir", str(tmp_path / "hf"), "--step", "0")
    assert res.returncode == 0 and "exported checkpoint-0" in res.stdout, res.stderr[-2000:]
    res = tool("convert_hf", "--model_name_or_path", str(tmp_path / "hf"),
               "--output_dir", str(tmp_path / "back"), "--no_expand_vocab")
    assert res.returncode == 0 and "wrote module-only checkpoint" in res.stdout, res.stderr[-2000:]
    res = tool("inspect_ckpt", str(tmp_path / "back"), "--verify")
    assert res.returncode == 0 and json.loads(res.stdout)["verify"]["status"] == "OK"
    got, _, _, _ = t_ckpt.load_module_checkpoint(str(tmp_path / "back"), device="cpu")
    _assert_params_equal(got, params)
