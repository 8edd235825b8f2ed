"""The jamba hybrid split over the mesh's ``"model"`` axis: its smoke
config (Mamba-2 layers of 8 SSD heads, a GQA layer, MoE layers) in fp32
on (1, 2), (1, 4) and (2, 2) gloo meshes, against the JAX package and
the one-process port (``test_torch_mp_mixers.check_split``), and a
checkpoint written on (1, 4) resumed on (2, 2) and on one process."""
import pytest

pytest.importorskip("torch")

from test_torch_mp_mixers import (BATCH, HP, MODEL_TOL, SEQ,  # noqa: E402
                                  SHAPE_IDS, SHAPES, _cfgs, _spawn,
                                  check_split)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mixers_split_match_jax_and_one_process(tmp_path, shape):
    check_split(tmp_path, "jamba", shape)


def test_jamba_checkpoint_reshards_one_by_four_to_two_by_two(tmp_path):
    """A (1, 4) jamba run's checkpoint (its Mamba-2 blocks, the columns
    every head reads written once, gathered whole) resumes on (2, 2),
    whose checkpoint resumes on one process: each resumed step's loss
    within ``MODEL_TOL`` of the unbroken one-process run's."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainHParams
    _, tcfg = _cfgs("jamba")
    kw = dict(seq=SEQ, hp=TrainHParams(**HP), device="cpu", ckpt_every=2,
              log_every=10 ** 9, batch_per_shard=BATCH)
    _, unbroken = train_loop(tcfg, steps=4, ckpt_dir=None, **kw)
    dirs = {k: str(tmp_path / k) for k in ("dir14", "dir22")}
    run = tmp_path / "run"
    run.mkdir()
    outs = _spawn(run, 4, "ckpt", dict(dirs, cfg=tcfg))
    _, last = train_loop(tcfg, steps=4, ckpt_dir=dirs["dir22"], **kw)
    got = outs[0]["first"] + outs[0]["then"] + last
    assert len(got) == 4, got
    for a, b in zip(got, unbroken):
        assert abs(a - b) <= MODEL_TOL * abs(b), (got, unbroken)
    assert all(o == outs[0] for o in outs)
