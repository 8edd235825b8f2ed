"""Cross attention and the encoder split over the mesh's ``"model"``
axis: seamless-m4t-medium's smoke config (2 encoder and 2 decoder
layers, 4 heads) in fp32 on (1, 2), (1, 4) and (2, 2) gloo meshes,
against the JAX package and the one-process port
(``test_torch_mp_mixers.check_split``; served through ``prefill
(enc_frames=)`` and ``decode_step``, the cross caches holding the
rank's KV heads)."""
import pytest

pytest.importorskip("torch")

from test_torch_mp_mixers import SHAPE_IDS, SHAPES, check_split  # noqa: E402


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mixers_split_match_jax_and_one_process(tmp_path, shape):
    check_split(tmp_path, "seamless", shape)
