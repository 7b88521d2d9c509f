"""The port's reference-checkpoint export (compat/torch_export.py): the
counterpart of tests/test_compat.py::test_export_state_dict_roundtrip_*.
The checkpoint is written in the reference's {'state_dict': ...} wrapper
and read back by compat/torch_convert.py into a model seeded otherwise."""

import pytest
import torch

from unipose_tpu_torch.compat.torch_convert import load_state_dict_intersection, load_torch_checkpoint
from unipose_tpu_torch.compat.torch_export import export_state_dict, save_reference_checkpoint
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict

REDUCED = (1, 1, 1, 1)
CONFIGS = {"image": ModelConfig(), "lstm": ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")}


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_export_state_dict_roundtrip(variant, tmp_path):
    source, fresh = (build_model(CONFIGS[variant], layers=REDUCED) for _ in range(2))
    load_numpy_state_dict(source, random_state_dict(source, seed=3))
    load_numpy_state_dict(fresh, random_state_dict(fresh, seed=4))
    want = export_state_dict(source)
    assert all(v.device.type == "cpu" for v in want.values())
    path = save_reference_checkpoint(source, str(tmp_path / "model_best.pth.tar"))
    assert set(torch.load(path, weights_only=True)) == {"state_dict"}
    report = load_state_dict_intersection(fresh, load_torch_checkpoint(path))
    assert report["skipped"] == [] and sorted(report["loaded"]) == sorted(want)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key
