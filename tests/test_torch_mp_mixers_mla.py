"""MLA split over the mesh's ``"model"`` axis: deepseek-v2-lite's smoke
config (4 MLA heads, a dense layer then MoE layers with a shared expert)
in fp32 on (1, 2), (1, 4) and (2, 2) gloo meshes, against the JAX
package and the one-process port (``test_torch_mp_mixers.check_split``:
held blocks in bytes, logits, loss, reduced gradient, 3 train steps and
masters, prefill logits and engine tokens, the latent cache whole)."""
import pytest

pytest.importorskip("torch")

from test_torch_mp_mixers import SHAPE_IDS, SHAPES, check_split  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mixers_split_match_jax_and_one_process(tmp_path, shape):
    check_split(tmp_path, "deepseek", shape)
