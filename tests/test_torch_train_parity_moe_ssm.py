"""One train step of each MoE, SSM and hybrid architecture's ``reduced``
config against the reference's (the body and its tolerances:
``tests/_torch_train.py``); jamba's f32-parameter run is in
``test_torch_train_parity.py``, to share the time evenly."""
import pytest

pytest.importorskip("jax")

from _torch_train import check_train_step  # noqa: E402


@pytest.mark.parametrize("name", ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b"))
def test_train_step_matches_reference(name):
    check_train_step(name)
