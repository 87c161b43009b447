"""The port's ``BucketedLoader`` prefetch thread ends with its epoch.

A consumer that leaves an epoch early (a ``break``, ``close()``, a trainer
epoch cut by ``steps_per_epoch_cap`` or ``reference_quirks``) used to leave
the worker thread blocked on a full queue for the life of the process,
holding the batches it had built. Here every cut epoch's worker ends within
``WAIT_S`` and ``threading.active_count()`` returns to its value at the
start; a full epoch gives the same batches as the loader without a thread;
an error in the worker reaches the consumer.
"""

import threading
import time

import numpy as np
import pytest
import torch

from modaltune_tpu_torch import create_aggregator, init_weights
from modaltune_tpu_torch.configs import TrainConfig, tiny_test_config
from modaltune_tpu_torch.data import BucketedLoader, SyntheticSlideDataset
from modaltune_tpu_torch.train.trainer import ModalTuneTrainer
from _one_thread import one_thread  # noqa: F401

WAIT_S = 5.0


def _dataset(n=5):
    return SyntheticSlideDataset(n_cases=n, in_chans=64, bag_range=(40, 80))


def _settles_at(count: int) -> bool:
    end = time.monotonic() + WAIT_S
    while threading.active_count() != count:
        if time.monotonic() > end:
            return False
        time.sleep(0.01)
    return True


def _batches_equal(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("bag", "coords", "mask", "genes", "text", "label",
                         "duration", "event")) and a.case_ids == b.case_ids


@pytest.mark.parametrize("how", ["break", "close"])
def test_cut_epoch_ends_the_worker(how):
    loader = BucketedLoader(_dataset(), buckets=(96,), prefetch=2)
    start = threading.active_count()
    for _ in range(3):
        if how == "break":
            for i, _batch in enumerate(loader):
                if i == 1:          # 2 of 5 batches
                    break
        else:
            it = iter(loader)
            next(it)
            next(it)
            assert threading.active_count() == start + 1
            it.close()
        assert _settles_at(start), threading.enumerate()


def test_full_epochs_give_the_batches_of_the_loader_without_a_thread():
    threaded = BucketedLoader(_dataset(7), buckets=(96,), batch_size=2,
                              seed=3)
    plain = BucketedLoader(_dataset(7), buckets=(96,), batch_size=2, seed=3,
                           prefetch=0)
    start = threading.active_count()
    for _ in range(2):                     # two epochs, two shuffles
        got, want = list(threaded), list(plain)
        assert len(got) == len(want) == 4
        assert all(_batches_equal(g, w) for g, w in zip(got, want))
    assert _settles_at(start)


def test_worker_error_reaches_the_consumer():
    class Failing:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def get(self, i, rng):
            if i == 3:
                raise OSError("unreadable bag")
            return self.inner.get(i, rng)

    start = threading.active_count()
    loader = BucketedLoader(Failing(_dataset()), buckets=(96,), shuffle=False)
    seen = 0
    with pytest.raises(OSError, match="unreadable bag"):
        for _ in loader:
            seen += 1
    assert seen == 3
    assert _settles_at(start)


def test_capped_trainer_epochs_end_the_worker(tmp_path):
    cfg = tiny_test_config()
    packer = SyntheticSlideDataset(n_cases=1).packer
    model = create_aggregator("longnetvit_gene_adapter", device="cpu",
                              cfg=cfg, n_gene_groups=packer.n_groups,
                              max_group_len=packer.max_group_len)
    init_weights(model, torch.Generator().manual_seed(0))
    datasets = {"train": _dataset()}
    trainer = ModalTuneTrainer(model, TrainConfig(steps_per_epoch_cap=2),
                               datasets, str(tmp_path), buckets=(96,))
    trainer.init_state(model.state_dict())
    start = threading.active_count()
    for epoch in range(3):
        trainer.train_one_epoch()
        assert len(trainer.step_ms) == 2 * (epoch + 1)
        assert _settles_at(start), threading.enumerate()
