"""The port's repo tools (tortoise_tpu_torch/tools: fetch_weights --offline,
import_voice_pack, make_demo_voices, convert_tokenizer) against the JAX
tools in tools/, each writing to tmp_path: the same files from the same
inputs, and the same flags."""
import argparse
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_apps import _options
from test_torch_weights import _ref_vocoder
from tortoise_tpu import weights as jax_weights

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_repo_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_parser(name: str, monkeypatch):
    """The argparse parser the JAX tool's main() builds, caught at parse."""
    class Parsed(Exception):
        pass

    captured = {}

    def capture(self, *args, **kwargs):
        captured["parser"] = self
        raise Parsed

    tool = _jax_tool(name)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed):
            tool.main()
    return captured["parser"]


@pytest.mark.parametrize("name", ["fetch_weights", "import_voice_pack"])
def test_tool_keeps_the_jax_tools_flags(name, monkeypatch):
    """Every flag of the JAX tool, with its default; the port's tools add
    --device (import_voice_pack's --latents runs on the card). The voice
    folders' defaults are the same folder by another path, and the source
    library's is $TORTOISE_EXTRA_VOICES_DIR with no fallback."""
    tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
    want = _options(_jax_parser(name, monkeypatch))
    got = _options(tool.build_parser())
    if name == "import_voice_pack":
        assert got.pop("device")["default"] == "cuda"
        assert os.path.realpath(got["dest"].pop("default")) == \
            os.path.realpath(want["dest"].pop("default"))
        got["source"].pop("default"), want["source"].pop("default")
    assert got == want


def test_make_demo_voices_writes_the_committed_voices(tmp_path):
    """The port's clips equal the committed demo_alto and demo_bass wavs
    byte for byte, and its demo_latents.npz arrays the committed ones."""
    from tortoise_tpu_torch.tools import make_demo_voices

    res = make_demo_voices.main(["--dest", str(tmp_path)])
    voices = ROOT / "tortoise_tpu" / "voices"
    assert len(res["written"]) == 5
    for name in ("demo_alto", "demo_bass"):
        for clip in ("1.wav", "2.wav"):
            assert (tmp_path / name / clip).read_bytes() == (voices / name / clip).read_bytes()
    with np.load(tmp_path / "demo_latents" / "demo_latents.npz") as got, \
            np.load(voices / "demo_latents" / "demo_latents.npz") as want:
        assert set(got.files) == set(want.files) == {"auto", "diffusion"}
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_make_demo_voices_defaults_to_the_shared_voices():
    from tortoise_tpu_torch.tools import make_demo_voices

    assert os.path.realpath(make_demo_voices.build_parser().parse_args([]).dest) == \
        os.path.realpath(ROOT / "tortoise_tpu" / "voices")


def test_convert_tokenizer_writes_the_jax_tools_json(tmp_path):
    """An HF tokenizer.json fixture rebuilt from the committed asset: both
    tools write the same bytes, and they are the port's bpe_vocab.json."""
    from tortoise_tpu_torch.tools import convert_tokenizer

    asset = ROOT / "tortoise_tpu_torch" / "data" / "bpe_vocab.json"
    a = json.loads(asset.read_text())
    fixture = {"version": "1.0",
               "added_tokens": [{"id": a["vocab"][t], "content": t, "special": True}
                                for t in a["special_tokens"]],
               "model": {"type": "BPE", "unk_token": a["unk_token"], "vocab": a["vocab"],
                         "merges": a["merges"]}}
    src = tmp_path / "tokenizer.json"
    src.write_text(json.dumps(fixture))
    _jax_tool("convert_tokenizer").convert(str(src), str(tmp_path / "jax.json"))
    res = convert_tokenizer.main([str(src), str(tmp_path / "port.json")])
    assert res == {"dst": str(tmp_path / "port.json"), "tokens": 255, "merges": 215}
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes() \
        == asset.read_bytes()


def _reference_library(root: Path) -> Path:
    """A reference-layout library: a clip voice (a wav and an mp3, copied
    as bytes), a latent voice (.pth of an (auto, diffusion) pair) and a
    file outside any voice folder."""
    lib = root / "library"
    (lib / "clipvoice").mkdir(parents=True)
    (lib / "latvoice").mkdir()
    rng = np.random.default_rng(0)
    from scipy.io.wavfile import write

    write(lib / "clipvoice" / "1.wav", 22050,
          (rng.standard_normal(2205) * 0.1).astype(np.float32))
    (lib / "clipvoice" / "2.mp3").write_bytes(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
    torch.save((torch.randn(1, 1024, generator=torch.Generator().manual_seed(1)),
                torch.randn(1, 2048, generator=torch.Generator().manual_seed(2))),
               lib / "latvoice" / "cond_latent.pth")
    (lib / "README").write_text("not a voice")
    return lib


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_import_voice_pack_writes_the_jax_tools_tree(tmp_path):
    """Clip mode on the same library: the same files, clips byte for byte
    and the .pth latent's .npz with equal arrays; --voices picks a subset."""
    from tortoise_tpu_torch.tools import import_voice_pack

    lib = _reference_library(tmp_path)
    jtool = _jax_tool("import_voice_pack")
    jdone = jtool.import_clips(str(lib), str(tmp_path / "jax"), sorted(os.listdir(lib)))
    res = import_voice_pack.main(["--source", str(lib), "--dest", str(tmp_path / "port")])
    assert res["voices"] == jdone == ["clipvoice", "latvoice"]
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert set(got) == set(want) == {"clipvoice/1.wav", "clipvoice/2.mp3",
                                     "latvoice/cond_latent.npz"}
    for k in ("clipvoice/1.wav", "clipvoice/2.mp3"):
        assert got[k].read_bytes() == want[k].read_bytes()
    with np.load(got["latvoice/cond_latent.npz"]) as g, \
            np.load(want["latvoice/cond_latent.npz"]) as w:
        assert set(g.files) == set(w.files) == {"auto", "diffusion"}
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k])
    sub = import_voice_pack.main(["--source", str(lib), "--dest", str(tmp_path / "sub"),
                                  "--voices", "latvoice"])
    assert sub["voices"] == ["latvoice"] and set(_tree(tmp_path / "sub")) == \
        {"latvoice/cond_latent.npz"}
    with pytest.raises(SystemExit):
        import_voice_pack.main(["--source", str(tmp_path / "missing")])


def test_import_voice_pack_latents_refuses_random_weights(tmp_path, monkeypatch):
    """--latents with no checkpoint anywhere: the quality API refuses to
    fall back to random weights, and nothing is written."""
    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.tools import import_voice_pack

    monkeypatch.setattr(weights, "MODELS_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(weights, "TORCH_MODELS_DIR", str(tmp_path / "reference"))
    lib = _reference_library(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        import_voice_pack.main(["--source", str(lib), "--dest", str(tmp_path / "out"),
                                "--latents", "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_fetch_weights_offline_converts_and_verifies(tmp_path, capsys):
    """A hand-built reference-layout vocoder.pth at the shipped config:
    converted to the JAX converter's tree, cached as its .npz, and verified
    against the shipped model; the absent families are skipped; a second
    run reads the cached .npz."""
    from tortoise_tpu_torch.tools import fetch_weights

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    torch.manual_seed(0)
    voc, _ = _ref_vocoder()
    torch.save({"model_g": voc}, src / "vocoder.pth")
    res = fetch_weights.main(["--offline", "--src", str(src), "--dst", str(dst)])
    assert res["vocoder"] == "ok"
    assert all(v.startswith("skipped") for k, v in res.items() if k != "vocoder")
    got = flatten_dict(jax_weights.load_params(str(dst / "vocoder.npz")))
    want = flatten_dict(jax_weights.convert_from_torch("vocoder", str(src / "vocoder.pth")))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    assert fetch_weights.main(["--offline", "--src", str(src), "--dst", str(dst),
                               "vocoder"]) == {"vocoder": "ok"}
    assert "already converted" in capsys.readouterr().out


def test_fetch_weights_reports_a_missing_key(tmp_path):
    """A cached tree with one key taken out fails the verify with the JAX
    tool's report of it; a family outside the list is refused; without
    --offline the tool raises."""
    from tortoise_tpu_torch.tools import fetch_weights

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    torch.manual_seed(0)
    voc, _ = _ref_vocoder()
    torch.save({"model_g": voc}, src / "vocoder.pth")
    tree = jax_weights.convert_from_torch("vocoder", str(src / "vocoder.pth"))
    del tree["conv_post"]["bias"]
    jax_weights.save_params(str(dst / "vocoder.npz"), tree)
    assert fetch_weights.main(["--offline", "--src", str(src), "--dst", str(dst),
                               "vocoder"]) == {"vocoder": "verify failed (1 problems)"}
    problems = fetch_weights.verify_coverage("vocoder", tree)
    assert problems == _jax_tool("fetch_weights").verify_coverage("vocoder", tree)
    assert problems == ["missing key conv_post/bias (1,)"]
    assert fetch_weights.main(["--offline", "--src", str(src), "--dst", str(dst),
                               "--force", "vocoder"]) == {"vocoder": "ok"}
    with pytest.raises(SystemExit):
        fetch_weights.main(["--offline", "nonesuch"])
    with pytest.raises(NotImplementedError, match="downloads are not ported"):
        fetch_weights.main(["vocoder"])


@pytest.mark.parametrize("name", ["autoregressive", "diffusion_decoder", "clvp", "cvvp",
                                  "vocoder", "classifier", "rlg_auto", "rlg_diffuser",
                                  "hifidecoder", "wav2vec2"])
def test_fetch_weights_shapes_are_the_jax_tools(name):
    """The shipped model's JAX-layout names and shapes, built on the meta
    device, equal the JAX tool's jax.eval_shape tree for every family."""
    from tortoise_tpu_torch.convert.from_jax import jax_shapes
    from tortoise_tpu_torch.tools import fetch_weights

    model = fetch_weights.shipped_model(name)
    assert all(p.is_meta for p in model.parameters())
    want = {"/".join(k): tuple(v.shape)
            for k, v in flatten_dict(_jax_tool("fetch_weights")._init_shape_tree(name)).items()}
    assert jax_shapes(model) == want
