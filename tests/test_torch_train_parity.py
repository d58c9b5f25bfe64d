"""One train step of each dense, vision-stub and encoder-decoder
architecture's ``reduced`` config against the reference's (the body and its
tolerances: ``tests/_torch_train.py``), and jamba's with f32 parameters."""
import pytest

pytest.importorskip("jax")

from _torch_train import check_train_step  # noqa: E402


@pytest.mark.parametrize("name", ("gemma-7b", "qwen3-0.6b", "minicpm-2b", "glm4-9b",
                                  "pixtral-12b", "whisper-tiny"))
def test_train_step_matches_reference(name):
    check_train_step(name)


def test_train_step_matches_reference_jamba_f32_params():
    check_train_step("jamba-1.5-large-398b", f32_params=True)
