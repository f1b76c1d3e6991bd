"""Checkpoint conversion and the npz writer of the port against the JAX package.

Same inputs to both packages (state dicts built here with nnU-Net naming,
the results-tree layout of ``tests/test_ckpt_tree.py``, the trained model-1
fold): the converted trees, the discovered entries and the written npz files
must be equal, array for array (conversion is a layout transpose and an f32
cast: no arithmetic, so equality is exact).  The CLI reads a fold from an
npz, a ``.model`` file or a raw nnU-Net tree and segments the same labels
from each, and ``convert-checkpoint`` writes the reference's files.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from braintpu.ckpt import convert as jax_convert
from braintpu.ckpt import discover as jax_discover
from braintpu.models import unet3d as jax_unet

from braintpu_torch import cli
from braintpu_torch.ckpt import convert, discover, npz
from braintpu_torch.io import nifti
from braintpu_torch.models import unet3d
from braintpu_torch.train.synthetic import write_synth_case

from test_ckpt_tree import TRAINER1, build_results_tree, tiny4
from test_unet_parity import make_torch_state_dict

REPO = Path(__file__).resolve().parent.parent
FOLD0 = REPO / "results" / "trained_synth" / "checkpoints" / "model1" / "fold_0.npz"


def _port_cfg(jcfg):
    """The port's config of a reference config (f32 compute, as the tests)."""
    return unet3d.UNetConfig(
        in_channels=jcfg.in_channels, num_classes=jcfg.num_classes,
        base_features=jcfg.base_features, max_features=jcfg.max_features,
        num_pool=jcfg.num_pool, conv_per_stage=jcfg.conv_per_stage,
        encoder_scale=jcfg.encoder_scale, norm=jcfg.norm,
        group_norm_groups=jcfg.group_norm_groups, patch_size=jcfg.patch_size,
        compute_dtype=torch.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert np.array_equal(la[k], lb[k]), k


def _nnunet_state_dict(tree, cps=2):
    """A reference-layout tree in nnU-Net naming and torch layouts."""
    def conv(prefix, blk):
        out = {f"{prefix}.conv.weight": blk["w"].transpose(4, 3, 0, 1, 2),
               f"{prefix}.conv.bias": blk["b"], f"{prefix}.instnorm.weight": blk["scale"],
               f"{prefix}.instnorm.bias": blk["shift"]}
        if "mean" in blk:
            out[f"{prefix}.instnorm.running_mean"] = blk["mean"]
            out[f"{prefix}.instnorm.running_var"] = blk["var"]
        return out

    P = len(tree["encoder"])
    sd = {}
    for d, stage in enumerate(tree["encoder"]):
        for c, blk in enumerate(stage):
            sd.update(conv(f"conv_blocks_context.{d}.blocks.{c}", blk))
    for c, blk in enumerate(tree["bottleneck"]):
        sd.update(conv(f"conv_blocks_context.{P}.0.blocks.{c}" if c < cps - 1
                       else f"conv_blocks_context.{P}.1.blocks.0", blk))
    for u, st in enumerate(tree["decoder"]):
        sd[f"tu.{u}.weight"] = st["up"]["w"].transpose(0, 4, 1, 2, 3)
        for c, blk in enumerate(st["blocks"]):
            sd.update(conv(f"conv_blocks_localization.{u}.0.blocks.{c}" if c < cps - 1
                           else f"conv_blocks_localization.{u}.1.blocks.0", blk))
        sd[f"seg_outputs.{u}.weight"] = st["seg"]["w"].transpose(4, 3, 0, 1, 2)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("norm,scale", [("batch", 1), ("group", 2)])
def test_convert_state_dict_equals_reference(norm, scale):
    jcfg = tiny4(norm, scale)
    sd = make_torch_state_dict(jcfg, seed=3)
    sd = {("module." + k if i % 2 else k): v for i, (k, v) in enumerate(sd.items())}
    got = convert.convert_state_dict(sd, _port_cfg(jcfg))
    _assert_trees_equal(got, jax_convert.convert_state_dict(sd, jcfg))
    # and the port reads it as its parameters
    npz.params_from_jax(got, _port_cfg(jcfg))


def test_convert_torch_checkpoint_file_equals_reference(tmp_path):
    jcfg = tiny4("batch", 1)
    path = tmp_path / "model_final_checkpoint.model"
    torch.save({"state_dict": make_torch_state_dict(jcfg, seed=4), "epoch": 1000}, path)
    _assert_trees_equal(convert.convert_torch_checkpoint(path, _port_cfg(jcfg)),
                        jax_convert.convert_torch_checkpoint(path, jcfg))
    bare = tmp_path / "bare.model"  # a state dict saved without the wrapper
    torch.save(make_torch_state_dict(jcfg, seed=4), bare)
    _assert_trees_equal(convert.convert_torch_checkpoint(bare, _port_cfg(jcfg)),
                        jax_convert.convert_torch_checkpoint(path, jcfg))


def test_convert_refuses_axial_and_mismatched_checkpoints():
    """An axial config given a plain state dict (no attention tensors)
    raises, as the reference's converter does; so does a config whose
    channel plan differs."""
    jcfg = tiny4("batch", 1)
    sd = make_torch_state_dict(jcfg, seed=5)
    axial_cfg = dataclasses.replace(_port_cfg(jcfg), axial_attention=True)
    with pytest.raises(KeyError, match="axial"):
        convert.convert_state_dict(sd, axial_cfg)
    with pytest.raises(KeyError, match="axial"):
        jax_convert.convert_state_dict(sd, dataclasses.replace(jcfg, axial_attention=True))
    wide = _port_cfg(tiny4("batch", 2))  # a config whose channel plan differs
    with pytest.raises(ValueError, match="does not match"):
        convert.convert_state_dict(sd, wide)


def test_discover_and_convert_tree_equal_reference(tmp_path):
    root = tmp_path / "nnUNet_results"
    build_results_tree(root, folds=(0, 1))
    got, want = discover.discover_nnunet_tree(root), jax_discover.discover_nnunet_tree(root)
    assert set(got) == set(want) == {"model1", "model2"}
    for m in got:
        assert (got[m].model, got[m].trainer, got[m].trainer_dir, got[m].folds,
                got[m].plans_pkl) == (want[m].model, want[m].trainer, want[m].trainer_dir,
                                      want[m].folds, want[m].plans_pkl)
        assert got[m].fold_indices == [0, 1]
    jcfgs = {"model1": tiny4("batch", 1), "model2": tiny4("group", 2)}
    port_out = discover.convert_nnunet_tree(root, tmp_path / "port",
                                            {k: _port_cfg(c) for k, c in jcfgs.items()})
    ref_out = jax_discover.convert_nnunet_tree(root, tmp_path / "ref", jcfgs)
    assert [p.relative_to(tmp_path / "port") for p in port_out] == \
        [p.relative_to(tmp_path / "ref") for p in ref_out]
    for p, r in zip(port_out, ref_out):
        with np.load(p) as a, np.load(r) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (p, k)
    # the same refusals: a fold that is not on disk, nothing to convert
    with pytest.raises(ValueError, match="fold"):
        discover.convert_nnunet_tree(root, tmp_path / "x", {"model1": _port_cfg(jcfgs["model1"])},
                                     folds=[3])
    with pytest.raises(FileNotFoundError):
        discover.convert_nnunet_tree(tmp_path / "port", tmp_path / "y")


def _odd_tree():
    """Digit-keyed dicts, escaped-looking keys, empty containers, f16 and
    int leaves: what the key escaping and the markers exist for."""
    rng = np.random.default_rng(0)
    return {
        "encoder": [[{"w": rng.standard_normal((3, 2)).astype(np.float32)}], []],
        "encoder_attn": {"0": {"x": np.arange(3)}, "K1": {"y": np.float16(rng.standard_normal(2))},
                         "__EMPTY_DICT__": {}},
        "empty": {}, "none": [],
    }


@pytest.mark.parametrize("writer", ["reference_writes", "port_writes"])
def test_npz_written_by_either_package_loads_equal_in_the_other(writer, tmp_path):
    tree = _odd_tree()
    path = tmp_path / "t.npz"
    if writer == "port_writes":
        npz.save_pytree_npz(tree, path)
        back = jax_convert.load_pytree_npz(path)
    else:
        jax_convert.save_pytree_npz(tree, path)
        back = npz.load_pytree_npz(path)
    assert npz.flatten_pytree(tree).keys() == jax_convert.flatten_pytree(tree).keys()
    assert back["empty"] == {} and back["none"] == [] and back["encoder"][1] == []
    assert set(back["encoder_attn"]) == {"0", "K1", "__EMPTY_DICT__"}
    _assert_trees_equal(back, tree)


def test_params_to_jax_inverts_params_from_jax(tmp_path):
    jcfg = tiny4("batch", 1)
    tree = jax.tree_util.tree_map(np.asarray, jax_unet.init_params(jcfg, 2))
    params = npz.params_from_jax(tree, _port_cfg(jcfg))
    params["encoder"][0][0]["w"] = params["encoder"][0][0]["w"].bfloat16()  # bf16 -> f32, exact
    back = npz.params_to_jax(params, _port_cfg(jcfg))
    tree["encoder"][0][0]["w"] = params["encoder"][0][0]["w"].float().numpy()
    _assert_trees_equal(back, tree)
    npz.save_pytree_npz(back, tmp_path / "fold_0.npz")
    _assert_trees_equal(jax_convert.load_pytree_npz(tmp_path / "fold_0.npz"), tree)
    params["decoder"][0]["up"]["w"] = params["decoder"][0]["up"]["w"][:1]
    with pytest.raises(ValueError, match="decoder/0/up/w"):
        npz.params_to_jax(params, _port_cfg(jcfg))


def test_cli_segments_the_same_labels_from_npz_model_and_raw_tree(tmp_path, capsys):
    """The trained model-1 fold as an npz, as ``<model>/fold_0/model_final_
    checkpoint.model`` and inside a raw nnU-Net tree: the engine reads each
    (the reference's three sources, in its order) and segments equal labels."""
    tree = npz.load_pytree_npz(FOLD0)
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00004-000", seed=4, shape=(30, 28, 26))
    roots = {"npz": tmp_path / "npz", "model": tmp_path / "model", "tree": tmp_path / "tree"}
    (roots["npz"] / "model1").mkdir(parents=True)
    (roots["npz"] / "model1" / "fold_0.npz").symlink_to(FOLD0)
    mfile = roots["model"] / "model1" / "fold_0" / "model_final_checkpoint.model"
    mfile.parent.mkdir(parents=True)
    torch.save({"state_dict": _nnunet_state_dict(tree), "epoch": 1000}, mfile)
    raw = roots["tree"] / "3d_fullres" / "Task500_BraTS2021" / TRAINER1 / "fold_0"
    raw.mkdir(parents=True)
    (raw / mfile.name).symlink_to(mfile)
    labels = {}
    for src, root in roots.items():
        out = tmp_path / f"out_{src}"
        assert cli.main(["segment", "--input", str(case), "--output", str(out),
                         "--checkpoints", str(root), "--models", "model1", "--folds", "1",
                         "--no-tta", "--device", "cpu"]) == 0
        labels[src] = nifti.load(out / "BraTS-SYN-00004-000.nii.gz").get_fdata(np.float32)
    log = capsys.readouterr().out
    assert log.count("# model1/fold_0: converting") == 2, log
    assert np.array_equal(labels["model"], labels["npz"])
    assert np.array_equal(labels["tree"], labels["npz"])
    assert len(np.unique(labels["npz"])) > 1  # a segmentation, not all background


@pytest.mark.parametrize("mode", ["file", "tree"])
def test_cli_convert_checkpoint_writes_the_reference_npz(mode, tmp_path, monkeypatch):
    """``convert-checkpoint`` of a ``.model`` file and of a whole results tree
    writes the same npz arrays as the reference's subcommand (both CLIs'
    model configs made tiny: compressing full-width f32 takes half a minute)."""
    import braintpu.models as jax_models
    from braintpu import cli as jax_cli

    for name, norm, scale in (("MODEL1_BN", "batch", 1), ("MODEL2_GN_LARGE", "group", 2)):
        monkeypatch.setattr(jax_models, name, tiny4(norm, scale))
        monkeypatch.setattr(unet3d, name, _port_cfg(tiny4(norm, scale)))
    root = tmp_path / "res"
    build_results_tree(root, folds=(0, 1))
    src = str(root) if mode == "tree" else \
        str(next(root.rglob(f"{TRAINER1}/fold_1/model_final_checkpoint.model")))
    outs = {}
    for who, main in (("port", cli.main), ("ref", None)):
        dest = tmp_path / who / ("" if mode == "tree" else "fold_1.npz")
        argv = ["convert-checkpoint", "--input", src, "--output", str(dest), "--config", "model1"]
        if mode == "tree":
            argv += ["--tree-folds", "0,1"]
        if main is None:
            args = jax_cli.build_parser().parse_args(argv)
            assert args.fn(args) == 0
        else:
            assert main(argv) == 0
        outs[who] = sorted(p.relative_to(tmp_path / who) for p in (tmp_path / who).rglob("*.npz"))
    assert outs["port"] == outs["ref"] and len(outs["port"]) == (4 if mode == "tree" else 1)
    for rel in outs["port"]:
        with np.load(tmp_path / "port" / rel) as a, np.load(tmp_path / "ref" / rel) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (rel, k)
