"""The port's evaluation path and batch inference against the JAX package's,
on the CPU.

Seeded JAX RAFT variables (perturbed from a numpy seed) go through
``raft_state_dict_from_jax`` into a ``.pth``; both packages' ``cli.evaluate
--model x.pth --iters 2`` then run on the layouts of ``test_torch_data.py``
(KITTI's frames at two sizes, each padded on its own).  The JAX model takes
its volume path on the CPU, the port the plain version of its lookup kernel;
their flows agree to ~1e-4 px (``tests/test_torch_raft.py``), so EPE must
agree to EPE_REL and F1 to one outlier pixel per frame.  ``cli.infer`` must
write the flows of ``predict_flow``, and the JAX CLI's files on the same
``.pth`` and pairs.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data import write_layouts

from understanding_flow_robustness_tpu.cli import evaluate as jcli
from understanding_flow_robustness_tpu.cli import infer as jinfer
from understanding_flow_robustness_tpu.flowviz import flowlib as jflowlib
from understanding_flow_robustness_tpu.models.raft_model import RAFT as JRAFT
from understanding_flow_robustness_tpu.training import evaluate as jev
from understanding_flow_robustness_tpu_torch.cli import evaluate as tcli
from understanding_flow_robustness_tpu_torch.cli import infer as tinfer
from understanding_flow_robustness_tpu_torch.flowviz import flowlib
from understanding_flow_robustness_tpu_torch.flowviz import io as fio
from understanding_flow_robustness_tpu_torch.models import (
    fetch_model,
    predict_flow,
    raft_state_dict_from_jax,
    scale_flow_head,
)
from understanding_flow_robustness_tpu_torch.native import (
    batch_u8_to_float01_pad,
)
from understanding_flow_robustness_tpu_torch.ops.interp import (
    compute_pad,
    remove_pad,
)
from understanding_flow_robustness_tpu_torch.training import evaluate as tev

torch.set_num_threads(2)

# relative EPE bound, port vs JAX: their f32 flows differ by ~1e-4 px
# (summation order in the lookup and the convolutions)
EPE_REL = 1e-4
FLOW_ATOL_PX = 2e-3   # per pixel, the submissions' flows


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evaluate")
    roots = write_layouts(str(tmp))
    rng = np.random.RandomState(0)
    jm = JRAFT(iters=2, mixed_precision=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 3)))
    # batch-norm statistics and biases away from their init values
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * rng.uniform(0.8, 1.2, np.shape(x)).astype(
            np.float32) + 0.01 * rng.randn(*np.shape(x)).astype(np.float32),
        jax.device_get(v))
    pth = str(tmp / "raft.pth")
    torch.save(raft_state_dict_from_jax(v), pth)
    # FlyingChairs reads its split file from the working directory
    os.makedirs(tmp / "datasets", exist_ok=True)
    os.replace(os.path.join(roots["chairs"], "chairs_split.txt"),
               tmp / "datasets" / "chairs_split.txt")
    return tmp, roots, pth


def _run(cli, setup, argv, capsys, monkeypatch, pth=None):
    tmp, roots, default_pth = setup
    pth = pth or default_pth
    monkeypatch.chdir(tmp)
    data = '{"kitti": "%s", "sintel": "%s", "chairs": "%s"}' % (
        roots["kitti"], roots["sintel"], os.path.join(roots["chairs"], "data"))
    extra = ["--device", "cpu"] if cli is tcli else []
    capsys.readouterr()
    cli.main(["--model", pth, "--iters", "2", "--data_roots", data]
             + argv + extra)
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?",
                                         capsys.readouterr().out)]


def test_validate_kitti(setup, capsys, monkeypatch):
    argv = ["--dataset", "kitti"]
    jepe, jf1 = _run(jcli, setup, argv, capsys, monkeypatch)
    tepe, tf1 = _run(tcli, setup, argv, capsys, monkeypatch)
    assert abs(tepe - jepe) <= EPE_REL * jepe
    # F1 within one outlier pixel per frame
    from understanding_flow_robustness_tpu_torch.data import KITTI

    ds = KITTI(root=setup[1]["kitti"])
    n_valid = sum(int((ds[i][3] >= 0.5).sum()) for i in range(len(ds)))
    assert abs(tf1 - jf1) / 100 * n_valid <= len(ds)
    assert 0 < tf1 < 100


def test_validate_kitti_small(setup, capsys, monkeypatch):
    """``--small`` (JAX cli/evaluate.py:40, 74-78): small RAFT from a
    ``.pth`` of seeded, perturbed JAX small-RAFT variables, KITTI's EPE and
    F1 against the JAX CLI's on the same file."""
    tmp = setup[0]
    rng = np.random.RandomState(1)
    v = jax.jit(JRAFT(iters=2, small=True).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * rng.uniform(0.8, 1.2, np.shape(x)).astype(
            np.float32) + 0.01 * rng.randn(*np.shape(x)).astype(np.float32),
        jax.device_get(v))
    pth = str(tmp / "raft_small.pth")
    torch.save(raft_state_dict_from_jax(v), pth)
    argv = ["--dataset", "kitti", "--small"]
    jepe, jf1 = _run(jcli, setup, argv, capsys, monkeypatch, pth)
    tepe, tf1 = _run(tcli, setup, argv, capsys, monkeypatch, pth)
    assert abs(tepe - jepe) <= EPE_REL * jepe
    from understanding_flow_robustness_tpu_torch.data import KITTI

    ds = KITTI(root=setup[1]["kitti"])
    n_valid = sum(int((ds[i][3] >= 0.5).sum()) for i in range(len(ds)))
    assert abs(tf1 - jf1) / 100 * n_valid <= len(ds)
    with pytest.raises(FileNotFoundError):  # as the JAX CLI's torch.load
        tcli.main(["--model", str(tmp / "none.pth"), "--dataset", "kitti",
                   "--small", "--device", "cpu"])


def test_validate_sintel_and_chairs(setup, capsys, monkeypatch):
    for dataset, n in (("sintel", 8), ("chairs", 1)):
        argv = ["--dataset", dataset]
        want = _run(jcli, setup, argv, capsys, monkeypatch)
        got = _run(tcli, setup, argv, capsys, monkeypatch)
        assert len(got) == len(want) == n
        # EPE (and Sintel's 1/3/5 px shares, whose pixels sit far from
        # their thresholds here)
        for g, w in zip(got, want):
            assert abs(g - w) <= EPE_REL * max(abs(w), 1.0), (dataset, g, w)


def test_submissions(setup, capsys, monkeypatch):
    tmp = setup[0]
    for cli in (jcli, tcli):
        for sub in ("kitti", "sintel"):
            _run(cli, setup, ["--dataset", sub, "--submission", sub,
                              "--warm_start", "--output_path",
                              str(tmp / f"{cli.__name__}_{sub}")],
                 capsys, monkeypatch)
    j, t = (str(tmp / f"{c.__name__}_kitti") for c in (jcli, tcli))
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t)) and len(names) == 3
    for n in names:
        jf, jv = fio.read_flow_png(os.path.join(j, n))
        tf, tv = fio.read_flow_png(os.path.join(t, n))
        assert np.array_equal(jv, tv)
        # 1/64-px quantised: a flow within FLOW_ATOL_PX of a step may land
        # on either side of it
        assert np.abs(jf - tf).max() <= 1 / 64 + 1e-6
    j, t = (str(tmp / f"{c.__name__}_sintel") for c in (jcli, tcli))
    n_files = 0
    for dirpath, _, files in os.walk(j):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), j)
            want = fio.read_flo(os.path.join(j, rel))
            got = fio.read_flo(os.path.join(t, rel))
            assert np.abs(got - want).max() <= FLOW_ATOL_PX, rel
            n_files += 1
    assert n_files == 2 * 2 * 2  # passes x scenes x pairs


def test_forward_interpolate():
    flow = (np.random.RandomState(9).randn(17, 23, 2) * 3).astype(np.float32)
    assert np.array_equal(tev.forward_interpolate(flow),
                          jev.forward_interpolate(flow))


def test_evaluate_refusals(setup, capsys, monkeypatch):
    """What the evaluate CLI still refuses, and the sharded KITTI
    validation it once refused (ROADMAP A13): ``--n_devices 1`` runs
    ``validate_kitti(mesh=)`` on a one-device mesh (one common padded
    geometry) and matches the JAX CLI's ``--n_devices 1`` at
    test_validate_kitti's bars; world 2: tests/test_torch_parallel.py."""
    _, _, pth = setup
    # --small is ported (test_validate_kitti_small); more CUDA ranks than
    # cards raise (no card here), sharding is KITTI validation's only
    with pytest.raises(ValueError, match="2 CUDA ranks"):
        tcli.main(["--model", pth, "--dataset", "kitti", "--n_devices", "2"])
    with pytest.raises(ValueError, match="KITTI validation only"):
        tcli.main(["--model", pth, "--dataset", "chairs", "--n_devices",
                   "2", "--device", "cpu"])
    # a .msgpack is read (tests/test_torch_checkpoint_msgpack.py); a
    # missing one is refused as a missing .pth is
    with pytest.raises(FileNotFoundError, match="x.msgpack"):
        tcli.main(["--model", "x.msgpack", "--dataset", "kitti"])
    argv = ["--dataset", "kitti", "--n_devices", "1"]
    jepe, jf1 = _run(jcli, setup, argv, capsys, monkeypatch)
    tepe, tf1 = _run(tcli, setup, argv, capsys, monkeypatch)
    assert abs(tepe - jepe) <= EPE_REL * jepe
    from understanding_flow_robustness_tpu_torch.data import KITTI

    ds = KITTI(root=setup[1]["kitti"])
    n_valid = sum(int((ds[i][3] >= 0.5).sum()) for i in range(len(ds)))
    assert abs(tf1 - jf1) / 100 * n_valid <= len(ds)


def test_infer_writes_predict_flow(tmp_path):
    """5 pairs at batch 2: two full batches and a ragged last one.  Every
    .flo equals predict_flow on the same decoded, padded batch, unpadded;
    the ragged batch's flow equals the full batch's within 1e-4 px; every
    _flow.png decodes to round(64 flow) / 64 within 1/64, every _viz.png to
    the colour wheel.  With ``--devices 2`` (two CPU ranks) the same .flo
    files within 1e-5 relative."""
    rng = np.random.RandomState(10)
    frames = rng.randint(0, 256, (5, 2, 61, 83, 3)).astype(np.uint8)
    for i in range(5):
        for k, f in enumerate(("10", "11")):
            fio.write_image(str(tmp_path / f"{i:06d}_{f}.png"), frames[i, k])
    out = tmp_path / "out"
    res = tinfer.main(["--dir", str(tmp_path), "--batch_size", "2",
                       "--save", "flo,png,viz", "--device", "cpu",
                       "--output_dir", str(out)])
    assert res["pairs"] == 5 and 0 < res["model_seconds"] <= res["seconds"]

    model = fetch_model("RAFT", device="cpu")
    pad = compute_pad(61, 83, mode="kitti", multiple=8)
    h, w = 61 + pad[0] + pad[1], 83 + pad[2] + pad[3]

    def predict(idx):
        a, b = (torch.from_numpy(batch_u8_to_float01_pad(
            frames[idx, k], h, w, pad[0], pad[2])) for k in (0, 1))
        return remove_pad(predict_flow(model, a, b).numpy(), pad)

    want = np.concatenate([predict([0, 1]), predict([2, 3]), predict([4])])
    full = predict(list(range(5)))
    assert np.abs(want - full).max() <= 1e-4
    for i in range(5):
        got = fio.read_flo(str(out / f"{i:06d}.flo"))
        assert np.array_equal(got, want[i])
        png, valid = fio.read_flow_png(str(out / f"{i:06d}_flow.png"))
        assert valid.all()
        assert np.abs(png - np.round(64 * want[i]) / 64).max() <= 1 / 64
        assert np.array_equal(fio.read_samples(str(out / f"{i:06d}_viz.png")),
                              flowlib.flow_to_image(want[i]))
    # --devices 2 (ROADMAP A13): two CPU ranks, each its slice of every
    # batch (the last repeated to full size), the .flo files of --devices 1
    two = tmp_path / "two"
    res = tinfer.main(["--dir", str(tmp_path), "--batch_size", "2",
                       "--devices", "2", "--device", "cpu",
                       "--output_dir", str(two)])
    assert res["pairs"] == 5 and 0 < res["model_seconds"] <= res["seconds"]
    assert sorted(os.listdir(two)) == [f"{i:06d}.flo" for i in range(5)]
    for i in range(5):
        got = fio.read_flo(str(two / f"{i:06d}.flo"))
        assert np.abs(got - want[i]).max() <= 1e-5 * np.abs(want[i]).max()


def test_infer_matches_jax_cli(setup, tmp_path, capsys):
    """Both packages' ``cli.infer`` on the same ``.pth`` (RAFT f32, 12
    iterations), pair list and flags: 3 pairs at batch 2, so a ragged last
    batch (the JAX CLI repeats it to full size, the port runs it as it
    is); RGB and grey frames; two pairs whose first frames share a
    basename in two directories (both CLIs append the pair index to the
    stem).  The flow head is scaled to trained-checkpoint magnitudes
    (~12 px here), as the serving checks do.  The same file names; every
    .flo within FLOW_ATOL_PX of the JAX CLI's (2e-5 px measured); every
    _flow.png within 1/64 (a step apart where a flow sits on a rounding
    edge); every _viz.png the JAX package's colour wheel of the port's own
    flow bit for bit, and within one level of the JAX CLI's file except at
    most at the pixel of largest radius: normalised by that radius, it sits
    at 1 within an ulp, where the wheel switches from the saturated colour
    to 0.75 of it (64 levels)."""
    # trained-checkpoint magnitudes: the flow head scaled by 0.05
    pth = str(tmp_path / "raft_calibrated.pth")
    torch.save(scale_flow_head(fetch_model(
        "RAFT_adv_kitti2012_ifgsm_l2_002", pretrained_path=setup[2],
        device="cpu").module, 0.05).state_dict(), pth)
    rng = np.random.RandomState(14)
    lines = []
    for i, (sub, name, channels) in enumerate(
            (("a", "frame", 3), ("b", "frame", 3), ("b", "grey", 1))):
        os.makedirs(tmp_path / sub, exist_ok=True)
        paths = [str(tmp_path / sub / f"{name}_{f}.png") for f in ("10", "11")]
        for path in paths:
            img = rng.randint(0, 256, (61, 83, channels)).astype(np.uint8)
            fio.write_image(path, img[..., 0] if channels == 1 else img)
        lines.append(" ".join(paths))
    (tmp_path / "pairs.txt").write_text("\n".join(lines) + "\n")
    argv = ["--flownet", "RAFT_adv_kitti2012_ifgsm_l2_002", "--pretrained",
            pth, "--pairs", str(tmp_path / "pairs.txt"), "--batch_size", "2",
            "--save", "flo,png,viz"]
    j, t = tmp_path / "jax", tmp_path / "port"
    assert jinfer.main(argv + ["--output_dir", str(j)]) == 3
    assert tinfer.main(argv + ["--output_dir", str(t), "--device",
                               "cpu"])["pairs"] == 3
    capsys.readouterr()
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t))
    stems = ["frame_10_000000", "frame_10_000001", "grey_10"]
    assert names == sorted(f"{s}{e}" for s in stems
                           for e in (".flo", "_flow.png", "_viz.png"))
    for s in stems:
        want = fio.read_flo(str(j / f"{s}.flo"))
        got = fio.read_flo(str(t / f"{s}.flo"))
        assert got.shape == want.shape == (61, 83, 2)
        assert np.abs(got - want).max() <= FLOW_ATOL_PX, s
        (jf, jv), (tf, tv) = (fio.read_flow_png(str(d / f"{s}_flow.png"))
                              for d in (j, t))
        assert jv.all() and tv.all() and np.abs(jf - tf).max() <= 1 / 64
        jz, tz = (fio.read_samples(str(d / f"{s}_viz.png")).astype(int)
                  for d in (j, t))
        assert jz.shape == tz.shape == (61, 83, 3)
        assert np.array_equal(tz, jflowlib.flow_to_image(got))
        off = np.argwhere((np.abs(jz - tz) > 1).any(-1))
        rad = np.linalg.norm(want, axis=-1)
        assert len(off) <= 1 and all(
            rad[tuple(p)] == rad.max() for p in off), (s, off)
