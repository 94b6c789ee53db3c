"""``chip_smoke.py``'s per-rank byte constants of granite's gloo mesh runs
against the port's mesh dry run on meta (``chip_smoke.mesh_predictions``
of the granite cells, as the script's ``dryrun`` phase runs it), each at
the depth its runs use. The card's ranks are held to these constants, so a
change of depth that left one stale would fail only there; here it fails
first."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

GRANITE = ("granite_1x4", "granite_2x2", "granite_fsdp_4x1",
           "granite_train_fsdp_2x2")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def predicted(smoke):
    return smoke.mesh_predictions(tags=GRANITE)


@pytest.mark.parametrize("tag, depth", [
    ("granite_1x4", "MESH_PINNED_LAYERS"),
    ("granite_2x2", "MESH_PINNED_LAYERS"),
    ("granite_fsdp_4x1", "MESH_FSDP_LAYERS"),
    ("granite_train_fsdp_2x2", "MESH_TRAIN_LAYERS"),
])
def test_the_granite_cells_run_at_their_runs_depth(smoke, predicted, tag,
                                                   depth):
    assert predicted[tag]["layers"] == getattr(smoke, depth)


def test_byte_constants_are_the_mesh_dry_runs(smoke, predicted):
    """``MESH_PARAM_BYTES``, ``MESH_FSDP_PARAM_BYTES`` and
    ``MESH_TRAIN_FSDP_BYTES`` (and the collective counts) as the script's
    ``dryrun`` phase holds them."""
    smoke._check_granite_predictions(predicted)


@pytest.mark.parametrize("name, tag", [
    ("MESH_PARAM_BYTES", "granite_1x4"),
    ("MESH_PARAM_BYTES", "granite_2x2"),
    ("MESH_FSDP_PARAM_BYTES", "granite_fsdp_4x1"),
])
def test_the_ranks_split_is_the_specs_at_that_depth(smoke, predicted, name,
                                                    tag):
    got = predicted[tag]
    shape = tuple(got["shape"])
    const = getattr(smoke, name)
    want = const[shape] if name == "MESH_PARAM_BYTES" else const
    assert want == smoke._rank_param_bytes(
        smoke._mesh_config(got["layers"]), shape, got["policy"]["fsdp"])
