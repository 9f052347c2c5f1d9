"""The port's command line on the CPU (`main(argv, device="cpu")`): the
miniature workflow of tests/test_cli.py (train two sources, eval with
`--save-viz`, soft multi-source and thresholded single-source pseudo,
one self-training round with `--ckpt-dir`, infer, export-torch and
import-torch), a cross-package case (the JAX CLI trains a source, and the
port's `pseudo` on that checkpoint agrees with the JAX CLI's `pseudo`),
encoder pretraining (`pretrain` in one package, `train
--pretrained-encoder` in the other, both ways), the train flags
`--bn-groups`, `--remat` and `--cm-decoder`, the reference's refusals, and
the subcommands and flags that belong to later slices."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mspl_tpu.cli import main as jax_main
from mspl_tpu.data.label_io import load_label_png as jax_load_label
from mspl_tpu.pseudo import generate as jax_generate
from mspl_tpu_torch.cli import load_model_checkpoint, main
from mspl_tpu_torch.data import native_io
from mspl_tpu_torch.data.label_io import (load_label_png, save_label_png,
                                          write_train_list)
from mspl_tpu_torch.pseudo import generate as port_generate
from mspl_tpu_torch.utils.registry import dataset_info

SIZE = ["--size", "32", "24"]
SMALL = ["--s", "0.5", "--batch-size", "4", "--epochs", "2", "--optimizer",
         "adam", "--lr", "0.005", "--scheduler", "fixed"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _make_png_dataset(root, name, num_classes, n=6, size_wh=(32, 24)):
    """A file-backed dataset in the reference's list format (list.txt with
    labels, unlabeled.txt without), written through the port's codec."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(sum(map(ord, name)))
    imgs, labs = [], []
    w, h = size_wh
    for i in range(n):
        ip, lp = f"img_{i}.png", f"lab_{i}.png"
        native_io.encode_png(os.path.join(root, ip),
                             rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        save_label_png(rng.integers(0, num_classes, (h, w)),
                       os.path.join(root, lp))
        imgs.append(ip)
        labs.append(lp)
    write_train_list(os.path.join(root, "list.txt"), imgs, labs)
    with open(os.path.join(root, "unlabeled.txt"), "w") as f:
        f.writelines(ip + "\n" for ip in imgs)
    return root


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """Two sources trained through `main(["train", ...])`, and the
    greenhouse target set."""
    tmp = tmp_path_factory.mktemp("cli")
    ckpts, roots = [], {}
    for ds in ("camvid", "forest"):
        root = _make_png_dataset(str(tmp / ds), ds,
                                 dataset_info(ds).num_classes)
        ck = str(tmp / f"ckpt_{ds}")
        res = main(["train", "--dataset", ds, "--data-root", root,
                    "--train-list", os.path.join(root, "list.txt"),
                    "--val-list", os.path.join(root, "list.txt"),
                    "--ckpt-dir", ck, "--class-weighting"] + SIZE + SMALL,
                   device="cpu")
        assert [h["epoch"] for h in res["history"]] == [0, 1]
        ckpts.append(ck)
        roots[ds] = root
    roots["greenhouse"] = _make_png_dataset(str(tmp / "greenhouse"),
                                            "greenhouse", 3)
    return dict(tmp=tmp, ckpts=ckpts, roots=roots)


def test_train_writes_model_and_train_state(workflow):
    """`train` leaves the per-epoch train state (last and best) and the
    model checkpoint with its meta, which rebuilds the model."""
    ck = workflow["ckpts"][0]
    assert sorted(os.listdir(ck)) == [
        "checkpoint_best.json", "checkpoint_best.msgpack",
        "checkpoint_last.json", "checkpoint_last.msgpack",
        "model_best.json", "model_best.msgpack"]
    model, _, meta = load_model_checkpoint(ck)
    assert meta["dataset"] == "camvid" and meta["num_classes"] == 11
    assert meta["input_hw"] == [24, 32] and meta["in_channels"] == 3
    assert model.num_classes == 11


@pytest.mark.parametrize("i", [0, 1], ids=["camvid", "forest"])
def test_eval_with_save_viz(workflow, i):
    """`eval --save-viz`: the mIoU of the in-process `evaluate`, and one
    colorized prediction PNG an image."""
    from mspl_tpu_torch.data.datasets import build_dataset
    from mspl_tpu_torch.data.loader import DataLoader
    from mspl_tpu_torch.engine.train import evaluate, make_eval_step

    ds = ("camvid", "forest")[i]
    root, ck = workflow["roots"][ds], workflow["ckpts"][i]
    viz = str(workflow["tmp"] / f"viz_{ds}")
    res = main(["eval", "--checkpoint", ck, "--data-root", root,
                "--val-list", os.path.join(root, "list.txt"),
                "--batch-size", "4", "--save-viz", viz] + SIZE, device="cpu")
    model, _, meta = load_model_checkpoint(ck)
    _, miou = evaluate(make_eval_step(model, meta["num_classes"],
                                      device="cpu"),
                       DataLoader(build_dataset(
                           ds, root, os.path.join(root, "list.txt"),
                           size_wh=(32, 24)), 4), meta["num_classes"])
    assert 0.0 <= res["miou"] <= 1.0 and abs(res["miou"] - miou) < 1e-12
    assert sorted(os.listdir(viz)) == [f"pred_{j:06d}.png" for j in range(6)]


def test_pseudo_soft_and_single_source(workflow):
    """Soft fusion of both sources with `--p`, and one source at a plain
    `--threshold`: a label PNG an image with values in the target space,
    the viz PNGs and the train list."""
    gh = workflow["roots"]["greenhouse"]
    out = str(workflow["tmp"] / "pseudo")
    res = main(["pseudo", "--checkpoints"] + workflow["ckpts"] + [
        "--data-root", gh, "--target-list", os.path.join(gh, "unlabeled.txt"),
        "--out-dir", out, "--fusion", "soft", "--p", "0.7",
        "--batch-size", "4", "--save-viz"] + SIZE, device="cpu")
    assert res["n"] == 6
    files = os.listdir(out)
    assert len([f for f in files if f.startswith("pseudo_")]) == 6
    assert len([f for f in files if f.startswith("viz_")]) == 6
    lines = open(os.path.join(out, "train_list.txt")).read().split("\n")
    assert len([ln for ln in lines if ln]) == 6
    lab = load_label_png(os.path.join(out, "pseudo_000000.png"))
    assert lab.shape == (24, 32) and set(np.unique(lab)) <= {0, 1, 2, 255}
    res1 = main(["pseudo", "--checkpoints", workflow["ckpts"][0],
                 "--data-root", gh,
                 "--target-list", os.path.join(gh, "unlabeled.txt"),
                 "--out-dir", str(workflow["tmp"] / "pseudo_single"),
                 "--threshold", "0.3", "--batch-size", "4"] + SIZE,
                device="cpu")
    assert res1["n"] == 6 and np.all(res1["kc"] == np.float32(0.3))


def test_selftrain_one_round(workflow):
    """One round through `selftrain`: the round's history, its train-state
    checkpoint under `--ckpt-dir`/round0, its label PNGs and train list
    under `--out-dir`, and the final model checkpoint."""
    gh = workflow["roots"]["greenhouse"]
    st, labels = workflow["tmp"] / "st_ckpt", workflow["tmp"] / "st_labels"
    res = main(["selftrain", "--checkpoints"] + workflow["ckpts"] + [
        "--data-root", gh, "--target-list", os.path.join(gh, "unlabeled.txt"),
        "--val-list", os.path.join(gh, "list.txt"), "--rounds", "1",
        "--p-init", "0.6", "--ckpt-dir", str(st), "--out-dir", str(labels)]
        + SIZE + SMALL, device="cpu")
    assert [h["round"] for h in res["history"]] == [0]
    assert res["history"][0]["n_sources"] == 2
    assert (st / "model_best.msgpack").exists()
    assert (st / "round0" / "checkpoint_last.msgpack").exists()
    assert len(list((labels / "round0").glob("pseudo_*.png"))) == 6
    assert (labels / "round0" / "train_list.txt").exists()


def test_infer_matches_the_in_process_forward(workflow):
    """`infer --save-conf`: prediction, viz and confidence PNGs an image;
    the predictions are the argmax of the loaded model's eval forward."""
    from mspl_tpu_torch.data.transforms import normalize

    gh, ck = workflow["roots"]["greenhouse"], workflow["ckpts"][1]
    out = workflow["tmp"] / "infer"
    res = main(["infer", "--checkpoint", ck, "--dataset", "greenhouse",
                "--data-root", gh, "--list", os.path.join(gh, "list.txt"),
                "--out-dir", str(out), "--save-conf", "--batch-size", "4"]
               + SIZE, device="cpu")
    assert res["n"] == 6 and len(os.listdir(out)) == 18
    model, _, _ = load_model_checkpoint(ck)
    img = native_io.decode_png(os.path.join(gh, "img_2.png"), (24, 32))
    with torch.inference_mode():
        want = model.eval()(normalize(torch.from_numpy(img[None]))).argmax(1)
    np.testing.assert_array_equal(load_label_png(str(
        out / "pred_000002.png")), want[0].numpy())


def test_export_then_import_torch(workflow, tmp_path):
    """`export-torch` writes the twin's state dict, `import-torch` reads it
    back into a native checkpoint: the same tree (the same bytes), and a
    .pth beside a JSON sidecar loads directly."""
    ck = workflow["ckpts"][0]
    pth = str(tmp_path / "w.pth")
    main(["export-torch", "--checkpoint", ck, "--out", pth], device="cpu")
    res = main(["import-torch", "--pth", pth, "--model", "espnetv2",
                "--num-classes", "11", "--s", "0.5", "--dataset", "camvid",
                "--out-dir", str(tmp_path / "imp")], device="cpu")
    assert res["n_torch_tensors"] == len(torch.load(pth))
    assert (tmp_path / "imp" / "model_best.msgpack").read_bytes() == \
        open(os.path.join(ck, "model_best.msgpack"), "rb").read()
    (tmp_path / "w.json").write_text(
        open(os.path.join(ck, "model_best.json")).read())
    _, variables, _ = load_model_checkpoint(pth)
    _, want, _ = load_model_checkpoint(ck)
    got, want = (jax.tree_util.tree_leaves_with_path(t)
                 for t in (variables, want))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


def _recording(module, store):
    real = module.generate_pseudo_labels

    def gen(*a, **k):
        out = real(*a, **k)
        store.append([np.asarray(x) for x in out])
        return out
    return gen


def test_port_pseudo_on_a_jax_checkpoint_agrees_with_jax(tmp_path,
                                                         monkeypatch):
    """The JAX CLI trains a source (1 epoch of 1 batch) and writes its
    checkpoint; the port's `pseudo` reads it.  The fused confidences agree
    within 1e-5 and the labels on more than 0.999 of the pixels with the
    JAX CLI's `pseudo` on the same files (as tests/test_torch_generate.py
    holds the generator), and so do the label PNGs both write."""
    root = _make_png_dataset(str(tmp_path / "camvid"), "camvid", 11, n=4)
    gh = _make_png_dataset(str(tmp_path / "gh"), "greenhouse", 3, n=4)
    ck = str(tmp_path / "ck")
    jax_main(["train", "--dataset", "camvid", "--data-root", root,
              "--train-list", os.path.join(root, "list.txt"),
              "--ckpt-dir", ck, "--s", "0.5", "--batch-size", "4",
              "--epochs", "1", "--optimizer", "adam", "--lr", "0.01",
              "--scheduler", "fixed"] + SIZE)
    got, want = [], []
    monkeypatch.setattr(port_generate, "generate_pseudo_labels",
                        _recording(port_generate, got))
    monkeypatch.setattr(jax_generate, "generate_pseudo_labels",
                        _recording(jax_generate, want))
    args = ["pseudo", "--checkpoints", ck, "--data-root", gh,
            "--target-list", os.path.join(gh, "unlabeled.txt"),
            "--fusion", "soft", "--p", "0.5", "--batch-size", "4"] + SIZE
    res = main(args + ["--out-dir", str(tmp_path / "port")], device="cpu")
    ref = jax_main(args + ["--out-dir", str(tmp_path / "jax")])
    (gl, gc, gi), (wl, wc, wi) = got[0], want[0]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
    assert (gl.astype(np.int32) == wl.astype(np.int32)).mean() > 0.999
    np.testing.assert_allclose(res["kc"], ref["kc"], rtol=0,
                               atol=1.0 / 1024)
    agree = np.mean([
        (load_label_png(str(tmp_path / "port" / f"pseudo_{i:06d}.png"))
         == jax_load_label(str(tmp_path / "jax" / f"pseudo_{i:06d}.png")))
        .mean() for i in range(4)])
    assert agree > 0.999


def _make_class_list(root, n=8, classes=4, size=32):
    """`image_path class_id` lines of class-colored noise PNGs (as the JAX
    package's ColorClassDataset), written through the port's codec."""
    from tests.test_cls import ColorClassDataset

    os.makedirs(root, exist_ok=True)
    ds = ColorClassDataset(num_classes=classes, size=size, length=n, seed=3)
    lines = []
    for i in range(n):
        img, cls = ds.load(i)
        native_io.encode_png(os.path.join(root, f"c_{i}.png"), img)
        lines.append(f"c_{i}.png {int(cls)}\n")
    with open(os.path.join(root, "cls.txt"), "w") as f:
        f.writelines(lines)
    return root


PRETRAIN = ["--size", "32", "32", "--s", "0.5", "--batch-size", "4",
            "--epochs", "1", "--optimizer", "adam", "--lr", "0.005",
            "--scheduler", "fixed"]
# a train of no epoch writes the model as it starts: the pretrained encoder
NO_EPOCH = ["--s", "0.5", "--epochs", "0", "--scheduler", "fixed"] + SIZE


def _base_net(path):
    from mspl_tpu_torch.utils.checkpoint import load_checkpoint

    tree, _ = load_checkpoint(path)
    return {c: tree[c]["base_net"] for c in ("params", "batch_stats")}


def _encoder(path):
    from mspl_tpu_torch.engine.train_cls import \
        encoder_variables_from_classifier
    from mspl_tpu_torch.utils.checkpoint import load_checkpoint

    tree, _ = load_checkpoint(path)
    return encoder_variables_from_classifier(tree)


def _same_leaves(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), p


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pretrain_checkpoint_crosses_packages(tmp_path, writer):
    """One package's `pretrain` writes the `eespnet_cls` checkpoint (its
    meta: dataset classification, num_classes, input_hw, best_acc); the
    other's `train --pretrained-encoder` starts from it: the segmentation
    model it writes after no epoch holds the classifier's levels 1-4 under
    `base_net`, bit for bit."""
    root = _make_class_list(str(tmp_path / "cls"))
    seg = _make_png_dataset(str(tmp_path / "camvid"), "camvid", 11, n=4)
    pre, ck = str(tmp_path / "pre"), str(tmp_path / "seg")
    pretrain = ["pretrain", "--data-root", root, "--train-list", "cls.txt",
                "--val-list", "cls.txt", "--ckpt-dir", pre] + PRETRAIN
    train = ["train", "--dataset", "camvid", "--data-root", seg,
             "--train-list", os.path.join(seg, "list.txt"),
             "--ckpt-dir", ck, "--pretrained-encoder", pre] + NO_EPOCH
    if writer == "jax":
        res = jax_main(pretrain)
        main(train, device="cpu")
    else:
        res = main(pretrain, device="cpu")
        jax_main(train)
    assert [h["epoch"] for h in res["history"]] == [0]
    with open(os.path.join(pre, "model_best.json")) as f:
        meta = json.load(f)
    assert meta == {"dataset": "classification", "model": "eespnet_cls",
                    "s": 0.5, "num_classes": 4, "bf16": False,
                    "input_hw": [32, 32], "best_acc": res["best_acc"]}
    _same_leaves(_base_net(os.path.join(ck, "model_best.msgpack")),
                 _encoder(os.path.join(pre, "model_best.msgpack")))


@pytest.mark.parametrize("flags", [["--bn-groups", "2", "--remat"],
                                   ["--cm-decoder"]],
                         ids=["bn-groups-remat", "cm-decoder"])
def test_train_flags_reach_the_step(tmp_path, flags):
    """`train --bn-groups 2 --remat` writes the model that `train
    --bn-groups 2` writes, bit for bit (remat changes no number), and not
    the plain run's; `train --cm-decoder` writes the plain run's model (the
    port's decoder is the channel-major one already; the JAX package holds
    its two decoders identical, tests/test_cm_decoder.py)."""
    root = _make_png_dataset(str(tmp_path / "camvid"), "camvid", 11, n=4)
    args = ["train", "--dataset", "camvid", "--data-root", root,
            "--train-list", os.path.join(root, "list.txt")] + SIZE + SMALL

    def run(name, extra):
        ck = str(tmp_path / name)
        main(args + ["--ckpt-dir", ck] + extra, device="cpu")
        return _base_net(os.path.join(ck, "model_best.msgpack"))

    got = run("flags", flags)
    plain = run("plain", [])
    if flags[0] == "--cm-decoder":
        _same_leaves(got, plain)
        return
    _same_leaves(got, run("groups", ["--bn-groups", "2"]))
    with pytest.raises(AssertionError):
        _same_leaves(got, plain)


@pytest.mark.parametrize("argv,match", [
    (["bench"], "A.5"),
    (["pseudo", "--checkpoints", "c", "--data-root", "r", "--target-list",
      "t", "--out-dir", "o", "--model-parallel", "2"], "A.6"),
    (["selftrain", "--checkpoints", "c", "--data-root", "r",
      "--target-list", "t", "--model-parallel", "2"], "A.6"),
], ids=["bench", "pseudo-model-parallel", "selftrain-model-parallel"])
def test_later_slices_exit_naming_their_roadmap_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv, device="cpu")


TRAIN = ["train", "--dataset", "camvid", "--data-root", "r", "--train-list",
         "l"]


@pytest.mark.parametrize("argv,match", [
    (TRAIN + ["--cm-decoder", "--model", "deeplabv3"], "espnetv2-only"),
    (TRAIN + ["--cm-decoder", "--bn-groups", "2"], "incompatible"),
    (["selftrain", "--checkpoints", "c", "--data-root", "r",
      "--target-list", "t", "--cm-decoder", "--model", "deeplabv3"],
     "espnetv2-only"),
    (TRAIN + ["--model", "deeplabv3", "--pretrained-encoder", "p"],
     "espnetv2"),
], ids=["cm-decoder-deeplab", "cm-decoder-bn-groups",
        "selftrain-cm-decoder-deeplab", "pretrained-encoder-deeplab"])
def test_the_reference_refusals_exit(argv, match):
    """The JAX CLI's refusals, before any file is read: `--cm-decoder` is
    espnetv2-only and takes no ghost-batch statistics, and a pretrained
    encoder initializes an espnetv2 model."""
    with pytest.raises(SystemExit, match=match):
        main(argv, device="cpu")


def test_the_command_line_needs_cuda():
    """Without a CUDA device the command line fails; it does not fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        main(["eval", "--checkpoint", "c", "--data-root", "r",
              "--val-list", "v"])
