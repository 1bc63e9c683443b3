"""The port's training data path against the JAX package's, on the CPU:
``fetch_dataset``'s stage mixes, the ``DataLoader``, ``SequenceFolder``
and the validation sets on the committed JPEG fixtures, patches and masks
from image files, and RAFT on frames under 64 px (an empty fourth pyramid
level).

The datasets read the small layouts of ``test_torch_data.py``.  An
augmented sample of the port, drawn from ``random.Random(s)`` and
``np.random.RandomState(s)``, must equal the JAX package's drawn after
``random.seed(s)`` and ``np.random.seed(s)``, bit for bit; the loader's
per-sample seeds make its batches the JAX package's samples in the JAX
package's shuffled order, and the same at 0 and 4 workers.
"""

import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_data import _same, write_layouts
from test_torch_raft import FLOW_ATOL_PX, _perturb

from understanding_flow_robustness_tpu.attacks import patch as jpatch
from understanding_flow_robustness_tpu.data import datasets as jds
from understanding_flow_robustness_tpu.data import loader as jloader
from understanding_flow_robustness_tpu.data import sequence_folders as jseq
from understanding_flow_robustness_tpu.data import transforms as jtr
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu_torch.attacks import patch as tpatch
from understanding_flow_robustness_tpu_torch.data import datasets as tds
from understanding_flow_robustness_tpu_torch.data import fixtures_dir
from understanding_flow_robustness_tpu_torch.data import loader as tloader
from understanding_flow_robustness_tpu_torch.data import sequence_folders as tseq
from understanding_flow_robustness_tpu_torch.data import transforms as ttr
from understanding_flow_robustness_tpu_torch.models import (
    RAFT,
    raft_state_dict_from_jax,
)

torch.set_num_threads(2)
CROP = (24, 32)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_layouts(str(tmp_path_factory.mktemp("layouts")))


@pytest.fixture
def in_tree(roots, tmp_path, monkeypatch):
    """The working directory both packages read ``datasets/chairs_split.txt``
    from (data/datasets.py:158-166), and the roots of ``fetch_dataset``."""
    os.makedirs(tmp_path / "datasets")
    shutil.copy(os.path.join(roots["chairs"], "chairs_split.txt"),
                tmp_path / "datasets" / "chairs_split.txt")
    monkeypatch.chdir(tmp_path)
    return {"chairs": os.path.join(roots["chairs"], "data"),
            "things": roots["things"], "sintel": roots["sintel"],
            "kitti": roots["kitti"]}


def _parts(ds):
    return ds.datasets if isinstance(ds, jds.ConcatFlowDataset) or isinstance(
        ds, tds.ConcatFlowDataset) else [ds]


def _jax_sample(ds, i, seed):
    random.seed(seed)
    np.random.seed(seed)
    return ds[i]


@pytest.mark.parametrize("stage,trans_rot", [
    ("chairs", False), ("chairs", True), ("things", True), ("sintel", False),
    ("kitti", False)])
def test_fetch_dataset_matches_the_jax_package(in_tree, stage, trans_rot):
    j = jds.fetch_dataset(stage, CROP, trans_rot=trans_rot, roots=in_tree)
    t = tds.fetch_dataset(stage, CROP, trans_rot=trans_rot, roots=in_tree)
    assert len(t) == len(j) > 0
    for jp, tp in zip(_parts(j), _parts(t), strict=True):
        assert (tp.image_list, tp.flow_list, tp.sparse) == (
            jp.image_list, jp.flow_list, jp.sparse)
        assert vars(tp.augmentor).keys() - {"photo_aug"} == \
            vars(jp.augmentor).keys() - {"photo_aug"}
        for k, v in vars(jp.augmentor).items():
            if k != "photo_aug":
                assert getattr(tp.augmentor, k) == v, k
    n = len(t)
    for i in sorted({0, 1, n // 2, n - 1}):
        for seed in (i, 100 + i):
            got = t.sample(i, random.Random(seed), np.random.RandomState(seed))
            _same(got, _jax_sample(j, i, seed))
            assert got[0].shape == CROP + (3,)


def _sintel(roots, aug=None):
    kw = dict(split="training", root=roots["sintel"], dstype="clean")
    return jds.MpiSintel(aug, **kw), tds.MpiSintel(aug, **kw)


def test_loader_order_and_batches_match_the_jax_package(roots):
    """Unaugmented samples, the loader as the train CLI runs it: the JAX
    loader's batches, shuffled order and reshuffle per epoch, divided by
    255 (the JAX batch's "pad", (0, 0, 0, 0) without padding, is read by
    nothing)."""
    jset, tset = _sintel(roots)
    kw = dict(batch_size=2, num_workers=0, seed=5)
    jl, tl = jloader.DataLoader(jset, **kw), tloader.DataLoader(tset, **kw)
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert w.pop("pad") == (0, 0, 0, 0)
            _same(g, w)
    # the last partial batch is dropped
    assert len(list(tloader.DataLoader(tset, batch_size=3,
                                       num_workers=0))) == 1


def test_augmented_batches_are_the_jax_samples_at_any_worker_count(roots):
    aug = {"crop_size": CROP, "min_scale": -0.2, "max_scale": 0.6,
           "do_flip": True}
    jset, tset = _sintel(roots, aug)
    runs = {}
    for workers in (0, 4):
        loader = tloader.DataLoader(tset, batch_size=2, num_workers=workers,
                                    seed=9)
        runs[workers] = [list(loader) for _ in range(2)]
    for a, b in zip(runs[0], runs[4]):
        for g, w in zip(a, b):
            _same(g, w)
    # the JAX samples in the JAX loader's order, drawn from the seeds the
    # port's loader gives them
    order = np.random.RandomState(9)
    seeds = np.random.RandomState([9, 1])
    collate = jloader.DataLoader(jset, batch_size=2)._collate
    for epoch in runs[0]:
        idx = np.arange(len(jset))
        order.shuffle(idx)
        s = seeds.randint(0, 2 ** 32, size=len(idx), dtype=np.uint64)
        for k, batch in enumerate(epoch):
            want = collate([_jax_sample(jset, int(i), int(x)) for i, x in
                            zip(idx[2 * k: 2 * k + 2], s[2 * k: 2 * k + 2])])
            assert want.pop("pad") == (0, 0, 0, 0)
            _same(batch, want)


def test_sequence_folder_matches_the_jax_package():
    root = fixtures_dir("kitti_raw_jpeg")
    jset = jseq.SequenceFolder(root, seed=3, train=True, transform=jtr.Compose(
        [jtr.RandomHorizontalFlip(), jtr.RandomScaleCrop(96, 160),
         jtr.ToFloat01()]))
    tset = tseq.SequenceFolder(root, seed=3, train=True)
    tset.transform = ttr.Compose([ttr.RandomHorizontalFlip(tset.rng),
                                  ttr.RandomScaleCrop(96, 160, tset.np_rng),
                                  ttr.ToFloat01()])
    assert len(tset) == len(jset) == 2
    for a, b in zip(tset.samples, jset.samples):
        _same(a, b)
    for _ in range(2):  # the transforms' draws continue across samples
        for i in range(len(tset)):
            got = tset[i]
            _same(got, jset[i])
            assert got[0].shape == (96, 160, 3) and len(got[1]) == 2
    val = tseq.SequenceFolder(root, seed=0, train=False, sequence_length=5)
    assert len(val) == 0  # four frames hold no 5-frame sequence


def test_patches_from_image_files_match_the_jax_package(tmp_path):
    rng = np.random.RandomState(4)
    paths = {}
    for name, shape in (("p.png", (40, 52, 3)), ("m.png", (33, 31)),
                        ("q.jpg", (45, 61, 3))):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        paths[name] = str(tmp_path / name)
        Image.fromarray(img).save(paths[name])
    for patch, mask in (("p.png", "m.png"), ("q.jpg", "p.png")):
        _same(tpatch.init_patch_from_image(paths[patch], paths[mask], 200,
                                           0.05),
              jpatch.init_patch_from_image(paths[patch], paths[mask], 200,
                                           0.05))
    npy = str(tmp_path / "p.npy")
    np.save(npy, rng.rand(1, 21, 21, 3))
    for mask in ("m.png", "q.jpg"):
        for kind in ("circle", "square"):
            _same(tpatch.get_patch_and_mask(patch_type=kind, patch_path=npy,
                                            mask_path=paths[mask]),
                  jpatch.get_patch_and_mask(patch_type=kind, patch_path=npy,
                                            mask_path=paths[mask]))


@pytest.mark.parametrize("corr_impl", ["alt", "volume"])
def test_raft_below_64_px_matches_the_jax_package(corr_impl):
    """56x88 frames: H/8 = 7, so the pooled levels have 7, 3, 1 and 0 rows.
    The JAX package's lookup on the CPU (its volume path) gives the empty
    level's taps as zeros, like any window outside a level; the port's
    alt and volume paths must give its flow."""
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=3, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    imgs = [(rng.rand(1, 56, 88, 3) * 255).astype(np.float32)
            for _ in range(2)]
    _, want = jax.jit(lambda v, a, b: jm.apply(v, a, b, test_mode=True))(
        v, *imgs)
    model = RAFT(iters=3, corr_impl=corr_impl).eval()
    model.load_state_dict(raft_state_dict_from_jax(v), strict=True)
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in imgs)
    with torch.inference_mode():
        _, up = model(a, b)
    got = up.permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, 56, 88, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=FLOW_ATOL_PX)


def test_empty_level_is_trimmed_before_the_kernels():
    """The lookups pass the kernels the live levels only and zero-extend
    their taps; a kernel's wrapper refuses an empty level before it builds
    or launches anything."""
    from understanding_flow_robustness_tpu_torch.ops import correlation

    fmap = torch.zeros((1, 7, 11, 16))
    levels = correlation.pool_fmap_levels(fmap, 4)
    assert [lvl.shape[1:3] for lvl in levels] == [(7, 11), (3, 5), (1, 2),
                                                  (0, 1)]
    live = correlation._live_levels(levels)
    assert len(live) == 3 and all(a is b for a, b in zip(live, levels))
    assert len(correlation._live_levels(levels[:3])) == 3
    taps = torch.ones((1, 77, 3 * 81))
    out = correlation._zero_taps(taps, 4, 4)
    assert out.shape == (1, 77, 4 * 81)
    assert bool((out[..., :243] == 1).all() and (out[..., 243:] == 0).all())
    assert correlation._zero_taps(out, 4, 4) is out


@pytest.mark.parametrize("wrapper", ["alt_corr_fwd", "alt_corr_bwd",
                                     "alt_corr_dcoords", "corr_lookup_fwd"])
def test_kernel_wrappers_refuse_an_empty_level(wrapper):
    from understanding_flow_robustness_tpu_torch.ops import correlation

    f1, levels = correlation.prepare_alt_corr(torch.zeros((1, 7, 11, 16)),
                                              torch.zeros((1, 7, 11, 16)), 4)
    coords = torch.zeros((1, 77, 2))
    g = torch.zeros((1, 77, 4 * 81))
    call = {
        "alt_corr_fwd": lambda: correlation._alt_corr_lookup_cuda(
            f1, levels, coords, 4),
        "alt_corr_bwd": lambda: correlation._alt_corr_bwd_cuda(
            f1, levels, coords, g, 4),
        "alt_corr_dcoords": lambda: correlation._alt_corr_dcoords_cuda(
            f1, levels, coords, g, 4),
        "corr_lookup_fwd": lambda: correlation.corr_lookup_fwd(
            [p.reshape(77, *p.shape[2:]) for p in
             correlation.volume_pyramid(torch.zeros((1, 7, 11, 16)),
                                        torch.zeros((1, 7, 11, 16)), 4)],
            coords[0]),
    }[wrapper]
    before = dict(correlation.LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="takes no empty level"):
        call()
    assert dict(correlation.LAUNCH_COUNTS) == before


def test_validation_sets_on_jpeg_match_the_jax_package(tmp_path):
    """``ValidationSet`` / ``ValidationSetPair`` read prepared-KITTI JPEG
    frames with a .npy GT each: the fixture scene, GT written here."""
    from understanding_flow_robustness_tpu.data import validation as jval
    from understanding_flow_robustness_tpu_torch.data import validation as tval

    root = tmp_path / "prepared"
    shutil.copytree(fixtures_dir("kitti_raw_jpeg"), root)
    rng = np.random.RandomState(6)
    for jpg in sorted(root.glob("*/*.jpg"))[:3]:
        np.save(str(jpg)[:-4] + ".npy",
                rng.randn(375, 1242, 3).astype(np.float32))
    for cls in ("ValidationSet", "ValidationSetPair"):
        j = getattr(jval, cls)(str(root), transform=jtr.Compose(
            [jtr.Scale(64, 200), jtr.ToFloat01()]))
        t = getattr(tval, cls)(str(root), transform=ttr.Compose(
            [ttr.Scale(64, 200), ttr.ToFloat01()]))
        assert len(t) == len(j) == (3 if cls == "ValidationSet" else 2)
        for i in range(len(t)):
            _same(t[i], j[i])
