"""s2tpu_torch's EDA and plot CLIs and its plotting loaders against the JAX package's.

On the suite's synthetic AOI: the label and sentinel statistics equal the
JAX package's number for number, ``cli.eda`` writes the same ``eda.json``
and prints the same report (and its figures), ``--segment-grid`` the same
segment count; the segment viewer steps through the segments as the JAX
one does (n / b / <index> / q), saving each view. The references are
``tests/test_profiling_eda.py:28-49`` and ``tests/test_infer_plotting.py:141,148``.
"""

import json
import tempfile

import numpy as np
import pytest

from s2tpu.cli import eda as jeda
from s2tpu.data.dataset import TiffSource as JaxTiffSource
from s2tpu_torch.cli import eda
from s2tpu_torch.data.dataset import TiffSource


@pytest.mark.parametrize("num_classes", [4, 6])
def test_eda_stats_equal_the_jax_packages(fixture_dir, num_classes):
    """osm-multiclass's 4 classes, and 6 (two never seen: zero counts)."""
    ours = TiffSource("small", "osm-multiclass", data_dir=fixture_dir)
    theirs = JaxTiffSource("small", "osm-multiclass", data_dir=fixture_dir)
    ls = eda.label_stats(ours, num_classes)
    assert ls == jeda.label_stats(theirs, num_classes)
    np.testing.assert_allclose(sum(ls["class_distribution"]), 1.0, rtol=1e-6)
    assert sum(ls["unlabeled_fraction_hist"]) == len(ours) and len(ls["class_counts"]) == num_classes
    assert eda.sentinel_stats(ours) == jeda.sentinel_stats(theirs)


def test_eda_cli_writes_the_jax_clis_report(fixture_dir, tmp_path, capsys):
    eda.main(["small", "osm-multiclass", "--data-dir", str(fixture_dir), "--out", str(tmp_path / "ours")])
    ours = capsys.readouterr().out
    jeda.main(["small", "osm-multiclass", "--data-dir", str(fixture_dir), "--out", str(tmp_path / "theirs")])
    assert ours == capsys.readouterr().out
    report = [json.loads((tmp_path / side / "eda.json").read_text()) for side in ("ours", "theirs")]
    assert report[0] == report[1] and report[0]["sentinel"]["segments"] == 6
    for name in ("class_distribution.png", "unlabeled_hist.png"):
        assert (tmp_path / "ours" / name).stat().st_size > 0


def test_eda_segment_grid_cli_equals_the_jax_clis(tmp_path, capsys):
    eda.main(["small", "osm-multiclass", "--segment-grid", "--out", str(tmp_path / "ours")])
    ours = capsys.readouterr().out
    jeda.main(["small", "osm-multiclass", "--segment-grid", "--out", str(tmp_path / "theirs")])
    assert json.loads(ours) == json.loads(capsys.readouterr().out) == {"aoi": "small", "segments": 6}
    assert (tmp_path / "ours" / "segment_grid_small.png").stat().st_size > 0


def test_eda_cli_writes_into_the_temporary_directory_by_default(tmp_path, monkeypatch, capsys):
    """Without ``--out`` the report lands in the temporary directory (the
    JAX CLI's /tmp/s2tpu_eda, under TMPDIR when it is set)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    eda.main(["small", "osm-multiclass", "--segment-grid"])
    assert json.loads(capsys.readouterr().out)["segments"] == 6
    assert (tmp_path / "s2tpu_eda" / "segment_grid_small.png").exists()


def test_load_sentinel_for_plotting_equals_the_jax_packages(fixture_dir):
    from s2tpu.plotting import load_sentinel_for_plotting as jax_load
    from s2tpu_torch.plotting import load_sentinel_for_plotting

    path = TiffSource("small", "osm-multiclass", data_dir=fixture_dir).sentinel_files[2]
    rgb, geo = load_sentinel_for_plotting(path)
    jrgb, jgeo = jax_load(path)
    np.testing.assert_array_equal(rgb, jrgb)
    assert rgb.dtype == np.uint8 and rgb.shape[-1] == 3 and rgb.max() == 255
    assert (geo.west, geo.north, geo.pixel_size_x, geo.pixel_size_y) == (
        jgeo.west, jgeo.north, jgeo.pixel_size_x, jgeo.pixel_size_y)


def test_plot_cli_steps_through_the_segments(fixture_dir, tmp_path, monkeypatch):
    """``cli.plot``'s viewer on the answers n, n, b, 5, 9, q: the segment it
    shows after each, as the JAX viewer's loop steps (past the last index it
    stays there), each view saved in the temporary directory."""
    from s2tpu_torch.cli import plot

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    answers, prompts = iter(["n", "n", "b", "5", "9", "q"]), []

    def answer(prompt):
        prompts.append(prompt)
        return next(answers)

    monkeypatch.setattr("builtins.input", answer)
    plot.main(["small", "osm-multiclass", "--data-dir", str(fixture_dir)])
    assert [p.split("]")[0] for p in prompts] == ["[0/5", "[1/5", "[2/5", "[1/5", "[5/5", "[5/5"]
    assert sorted(p.name for p in tmp_path.glob("s2tpu_view_*.png")) == [f"s2tpu_view_{i}.png" for i in (0, 1, 2, 5)]
    with pytest.raises(SystemExit):
        plot.main(["nowhere", "osm-multiclass"])
