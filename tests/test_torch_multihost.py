"""The port's multi-process training against the JAX package's, on the CPU.

* ``process_datalist`` and ``_first_slurm_host`` equal JAX's on the same
  inputs; every helper of ``parallel/multihost.py`` is a passthrough in a
  single process;
* on 2 gloo ranks: ``allgather_embeddings`` with uneven counts and ids of
  uneven widths, ``process_sum``, ``global_steps_min``, a
  ``DdpGradSync`` step that leaves both ranks with bit-equal parameters,
  equal to one step on the averaged gradients, and ``global_mesh`` with
  each rank's rows of a global batch;
* the trainer under 2-process DDP (``tests/_mh_common.py``'s pattern on
  the port): both ranks score the whole val split equally, and equal to a
  single-process trainer (1e-5 on the loss, 1e-9 on the rest, JAX's
  bars); rank 1 writes no file; the synchronized step cap; and, the
  reference fault F2 repaired, rank 1 ends with rank 0's best weights
  although its own run directory holds a stale file of that name;
* the pan-cancer trainer's evaluate on a 2-rank data mesh, the last batch
  wrap-padded: the per-site metrics of a single-process run;
* the CLI: ``--dp 2 --device cpu`` and ``--distributed 1`` in two
  processes of a ``WORLD_SIZE=2`` environment run to their end.

Every multi-process run has its own time limit (``tests/_torch_mp.py``,
and ``subprocess`` timeouts for the CLI).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mp as tmp_ranks
from modaltune_tpu.parallel import multihost as j_mh
from modaltune_tpu_torch.configs import TrainConfig
from modaltune_tpu_torch.parallel import multihost as mh
from modaltune_tpu_torch.train.state import TrainOptimizer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 180     # seconds, for every multi-process run


def test_datalist_and_slurm_host_match_jax():
    items = [f"s{i}" for i in range(11)]
    for n in (1, 2, 3, 5):
        for pid in range(n):
            assert mh.process_datalist(items, pid, n) == \
                j_mh.process_datalist(items, pid, n)
    for nodes in ("node001", "node001,node002", "node[001-004]",
                  "node[001-004,007]", "gpu[17,19-21],other"):
        assert mh._first_slurm_host(nodes) == j_mh._first_slurm_host(nodes)


def test_single_process_passthroughs(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert mh.init_distributed(device="cpu") == (0, 1)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    out, ids = mh.allgather_embeddings(x, ["a", "b", "c"])
    np.testing.assert_array_equal(out, x)
    assert ids == ["a", "b", "c"]
    np.testing.assert_array_equal(mh.allgather_embeddings(x), x)
    np.testing.assert_array_equal(mh.process_sum(np.asarray([1.0, 2.0])),
                                  [1.0, 2.0])
    assert mh.global_steps_min(7) == 7
    assert mh.process_datalist([1, 2, 3]) == [1, 2, 3]


def test_two_rank_gathers_and_grad_sync(tmp_path):
    ranks = tmp_ranks.run_ranks(tmp_ranks.collectives_worker, 2, tmp_path,
                                timeout=LIMIT)
    (x0, ids0), (x1, ids1) = ranks[0][0], ranks[1][0]
    want_ids = ["case0_0", "case0_1", "case0_2", "case1_0x", "case1_1x"]
    assert ids0 == ids1 == want_ids
    want_x = np.concatenate([np.zeros((3, 4)) + np.arange(3)[:, None],
                             np.ones((2, 4)) + np.arange(2)[:, None]])
    np.testing.assert_array_equal(x0, want_x)
    np.testing.assert_array_equal(x1, want_x)
    for r in ranks:
        np.testing.assert_allclose(r[1], [4.5, 1.0])
        assert r[2] == 4                       # min(5, 4)
    assert ranks[0][7] == [0, 2, 4, 6] and ranks[1][7] == [1, 3, 5]
    for r, (shape, rows) in enumerate(x[8] for x in ranks):
        assert shape == (2, 1) and rows["clinical"] is None
        np.testing.assert_array_equal(
            rows["bag"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
    # one step on the averaged gradients, here
    torch.manual_seed(0)
    params = {"a": torch.nn.Parameter(torch.randn(3, 4)),
              "b": torch.nn.Parameter(torch.randn(5))}
    opt = TrainOptimizer(TrainConfig(lr=0.1), params.values(), 1)
    for k, p in params.items():
        p.grad = torch.from_numpy((ranks[0][3][k] + ranks[1][3][k]) / 2)
    opt.step()
    np.testing.assert_allclose(float(ranks[0][5]), 0.375)
    for k, p in params.items():
        np.testing.assert_array_equal(ranks[0][6][k], ranks[1][6][k])
        np.testing.assert_allclose(ranks[0][6][k], p.detach().numpy(),
                                   rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    dirs = [str(tmp / f"rank{r}") for r in range(2)]
    ranks = tmp_ranks.run_ranks(tmp_ranks.ddp_trainer_worker, 2, tmp,
                                dict(dirs=dirs), timeout=LIMIT)
    trainer, state = tmp_ranks.build_trainer(tmp / "single")
    trainer.init_state(state)
    trainer.fit_readout_heads()
    return ranks, trainer.evaluate("val")


def test_ddp_trainer_scores_the_whole_split(ddp_run):
    """Both ranks' val metrics before training are equal, and equal to the
    single-process trainer's; only rank 0 writes eval files; 5 cases over
    2 processes cap the synchronized steps at 2."""
    ranks, expected = ddp_run
    m0, m1 = ranks[0][0], ranks[1][0]
    assert m0 == m1
    assert set(m0) == set(expected)
    for k, v in expected.items():
        tol = 1e-5 if k.endswith("_loss") else 1e-9
        assert abs(m0[k] - float(v)) <= tol * max(1.0, abs(float(v))), \
            (k, m0[k], float(v))
    assert ranks[0][1] and not ranks[1][1]
    assert ranks[0][2] == ranks[1][2] == 2


def test_ddp_trainer_reloads_rank0_best_weights(ddp_run):
    """F2 repaired: after ``run()`` both ranks hold the best weights rank
    0 wrote, bit for bit; rank 1's own directory held a stale
    ``best_model_weights.pt`` of zeros, which it never read."""
    ranks, _ = ddp_run
    best = ranks[0][4]
    assert any(np.abs(v).max() > 0 for v in best.values())
    for r in ranks:
        state = r[3]
        assert set(state) == set(best)
        for k in best:
            np.testing.assert_array_equal(state[k], best[k], err_msg=k)


def test_pancancer_evaluate_under_dp_matches_one_process(tmp_path):
    """PanCancerTrainer.evaluate on a 2-rank data mesh (batch 4 over 14
    train cases: the last batch wrap-padded by 2 rows) equals the
    single-process metrics from the same trained parameters: the padded
    rows stay out of the loss and of every site's pool (the JAX test is
    ``tests/test_pancancer.py:124``; its bars)."""
    plain, state = tmp_ranks.build_trainer(
        tmp_path / "plain", n_cases=(14, 10, 10), pancancer=True,
        batch_size=4)
    plain.init_state(state)
    plain.train_one_epoch()
    trained = {k: v.detach().numpy().copy()
               for k, v in plain.model.state_dict().items()}
    ranks = tmp_ranks.run_ranks(
        tmp_ranks.mesh_pancancer_worker, 2, tmp_path,
        dict(dir=str(tmp_path / "mesh"), state=trained), timeout=LIMIT)
    plain.fit_readout_heads()
    want = plain.evaluate("val")
    assert any("_site" in k for k in want)
    for got in ranks:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def _cli(args, env, cwd):
    return subprocess.run(
        [sys.executable, "-m", "modaltune_tpu_torch.tools.train", "--tiny",
         "1", "--synthetic", "1", "--device", "cpu", "--num_epochs", "1",
         *args], capture_output=True, text=True, timeout=LIMIT, env=env,
        cwd=cwd)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS"):
        env.pop(var, None)
    env.update(extra)
    return env


def test_cli_dp_runs_to_its_end(tmp_path):
    """``--dp 2 --device cpu`` spawns two workers over gloo: the batch size
    is rounded up to 2, the run ends, rank 0 writes the run's files."""
    done = _cli(["--dp", "2", "--output_path", str(tmp_path)], _env(), ROOT)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert "--dp: data-parallel over 2 devices" in done.stdout
    assert "batch_size rounded up to 2" in done.stdout
    assert "best val metric" in done.stdout
    assert (tmp_path / "seed_0" / "summary.json").exists()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_distributed_runs_to_its_end(tmp_path):
    """``--distributed 1`` in two processes of a ``WORLD_SIZE=2``
    environment: both bootstrap from it, train their shards and end."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "modaltune_tpu_torch.tools.train", "--tiny",
         "1", "--synthetic", "1", "--device", "cpu", "--num_epochs", "1",
         "--distributed", "1", "--output_path", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=_env(RANK=str(r), WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    assert "best val metric" in outs[0]
    assert "best val metric" not in outs[1]
    assert (tmp_path / "seed_0" / "summary.json").exists()
