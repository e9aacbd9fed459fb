"""kubeshare_tpu_torch/models/{data,checkpoint}.py: the Prefetcher and
checkpoint/resume, mirroring tests/test_parallel.py's prefetcher test
and tests/test_checkpoint.py's cases on the port's API (``torch.save``
of the model's and optimizer's ``state_dict``s), on the CPU. Restored
tensors are compared bit for bit; a resumed run against an
uninterrupted one at 1e-6 relative (the same float32 steps)."""

import gc
import os
import threading
import time

import pytest
import torch

from kubeshare_tpu_torch.models.checkpoint import (
    AsyncCheckpointManager, latest_checkpoint, restore_checkpoint,
    save_checkpoint,
)
from kubeshare_tpu_torch.models.data import (
    Prefetcher, prefetch_to_device, stage_to_device,
)


def tiny_model(seed: int = 0) -> torch.nn.Linear:
    torch.manual_seed(seed)
    return torch.nn.Linear(4, 4)


class TestPrefetcher:
    def test_order_depth_errors_and_close(self):
        produced = []

        def source():
            for i in range(6):
                produced.append(i)
                yield torch.full((4,), i)

        got = [int(x[0]) for x in prefetch_to_device(source(), size=2,
                                                     device="cpu")]
        assert got == list(range(6)) and produced == list(range(6))

        # bounded depth: a stalled consumer stages at most size + 1
        # batches (one in the transfer slot)
        pulled = []

        def endless():
            for i in range(100):
                pulled.append(i)
                yield torch.zeros(1)

        slow = prefetch_to_device(endless(), size=2, device="cpu")
        time.sleep(0.3)
        qsize = slow._queue.qsize()
        slow.close()
        assert qsize <= 2 and len(pulled) <= 4

        # exceptions surface at the consumer
        def broken():
            yield torch.zeros(1)
            raise RuntimeError("input pipeline died")

        it = prefetch_to_device(broken(), size=2, device="cpu")
        next(it)
        with pytest.raises(RuntimeError, match="pipeline died"):
            next(it)

        # close() mid-stream joins the worker
        with prefetch_to_device(iter(torch.zeros(1) for _ in range(1000)),
                                size=2, device="cpu") as p:
            next(p)
        assert not p._thread.is_alive()

    def test_transfer_stages_nested_items(self):
        calls = []

        def transfer(item):
            calls.append(threading.current_thread().name)
            return {"x": item[0] * 2, "n": item[1]}

        items = list(Prefetcher(iter([(torch.ones(2), 3)]), size=1,
                                transfer=transfer))
        assert torch.equal(items[0]["x"], torch.full((2,), 2.0))
        assert items[0]["n"] == 3
        assert calls and calls[0] != threading.current_thread().name
        staged = stage_to_device({"a": [torch.ones(1), (torch.zeros(2),)],
                                  "b": 1}, torch.device("cpu"))
        assert torch.equal(staged["a"][1][0], torch.zeros(2))
        assert staged["b"] == 1

    def test_default_transfer_needs_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Prefetcher(iter([]))
        assert list(Prefetcher(iter([1, 2]), transfer=None)) == [1, 2]

    def test_size_must_be_positive(self):
        with pytest.raises(ValueError, match="size"):
            Prefetcher(iter([]), size=0, transfer=None)

    def test_abandoned_prefetcher_is_stopped_by_gc(self):
        p = Prefetcher(iter(torch.zeros(1) for _ in range(10 ** 6)),
                       size=1, transfer=None)
        thread = p._thread
        next(p)
        del p
        gc.collect()
        thread.join(timeout=5)
        assert not thread.is_alive()


class TestCheckpoint:
    def test_roundtrip_with_opt_state(self, tmp_path):
        model = tiny_model()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        model(torch.ones(2, 4)).sum().backward()
        opt.step()
        ckpt_dir = str(tmp_path / "ck")
        save_checkpoint(ckpt_dir, 7, model, opt)
        fresh = tiny_model(seed=1)
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
        step, params, opt_state = restore_checkpoint(ckpt_dir, fresh,
                                                     fresh_opt)
        assert step == 7
        assert torch.equal(fresh.weight, model.weight)
        assert torch.equal(params["bias"], model.bias)
        # Adam's state (step, exp_avg, exp_avg_sq) survives
        got = fresh_opt.state_dict()["state"][0]
        want = opt.state_dict()["state"][0]
        assert set(got) == set(want) == set(opt_state["state"][0])
        assert all(torch.equal(got[k], want[k]) for k in want)

    def test_empty_dir_returns_none(self, tmp_path):
        assert restore_checkpoint(str(tmp_path / "nope")) is None
        assert latest_checkpoint(str(tmp_path / "nope")) is None

    def test_latest_wins_and_pruning(self, tmp_path):
        model = tiny_model()
        ckpt_dir = str(tmp_path / "ck")
        for step in (1, 2, 3, 4, 5):
            with torch.no_grad():
                model.bias.fill_(step)
            save_checkpoint(ckpt_dir, step, model, keep=3)
        assert latest_checkpoint(ckpt_dir) == 5
        restored = restore_checkpoint(ckpt_dir)
        assert restored[0] == 5 and restored[2] is None
        assert torch.equal(restored[1]["bias"], torch.full((4,), 5.0))
        assert restore_checkpoint(ckpt_dir, step=3)[0] == 3
        assert restore_checkpoint(ckpt_dir, step=1) is None
        assert sorted(os.listdir(ckpt_dir)) == [
            "step_0000000003", "step_0000000004", "step_0000000005"]
        with pytest.raises(ValueError, match="keep"):
            save_checkpoint(ckpt_dir, 6, model, keep=0)

    def test_resume_continues_training(self, tmp_path):
        """A killed-and-resumed run matches an uninterrupted one."""
        x = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))

        def run(model, opt, steps):
            for _ in range(steps):
                opt.zero_grad()
                (model(x) ** 2).mean().backward()
                opt.step()

        ref = tiny_model()
        ref_opt = torch.optim.Adam(ref.parameters(), lr=0.1)
        run(ref, ref_opt, 6)

        ckpt_dir = str(tmp_path / "ck")
        model = tiny_model()
        opt = torch.optim.Adam(model.parameters(), lr=0.1)
        run(model, opt, 3)
        save_checkpoint(ckpt_dir, 3, model, opt)

        resumed = tiny_model(seed=5)
        resumed_opt = torch.optim.Adam(resumed.parameters(), lr=0.1)
        assert restore_checkpoint(ckpt_dir, resumed, resumed_opt)[0] == 3
        run(resumed, resumed_opt, 3)
        torch.testing.assert_close(resumed.weight, ref.weight, rtol=1e-6,
                                   atol=0)

    def test_a_rewrite_of_the_same_step_replaces_it(self, tmp_path):
        model = tiny_model()
        save_checkpoint(str(tmp_path), 2, model)
        with torch.no_grad():
            model.bias.fill_(9.0)
        save_checkpoint(str(tmp_path), 2, model)
        assert torch.equal(restore_checkpoint(str(tmp_path))[1]["bias"],
                           torch.full((4,), 9.0))
        assert sorted(os.listdir(tmp_path)) == ["step_0000000002"]


class TestAsyncCheckpoint:
    def test_async_roundtrip_and_prune(self, tmp_path):
        model = tiny_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        with AsyncCheckpointManager(str(tmp_path), keep=2) as mgr:
            for step in (1, 2, 3):
                with torch.no_grad():
                    model.bias.fill_(step)
                mgr.save(step, model, opt)
            mgr.wait()
        steps = sorted(int(p.name[5:]) for p in tmp_path.iterdir()
                       if p.name.startswith("step_"))
        assert steps == [2, 3]  # pruned to keep=2
        step, params, opt_state = restore_checkpoint(str(tmp_path))
        assert step == 3
        assert torch.equal(params["bias"], torch.full((4,), 3.0))
        assert opt_state["param_groups"][0]["lr"] == 0.1

    def test_keep_must_be_positive(self, tmp_path):
        with pytest.raises(ValueError, match="keep"):
            AsyncCheckpointManager(str(tmp_path), keep=0)

    def test_save_snapshots_before_returning(self, tmp_path):
        """The caller may update the model right after save(): the
        checkpoint holds the values at the call."""
        model = tiny_model()
        want = model.weight.detach().clone()
        with AsyncCheckpointManager(str(tmp_path)) as mgr:
            mgr.save(1, model)
            with torch.no_grad():
                model.weight.mul_(100.0)
        _, restored, _ = restore_checkpoint(str(tmp_path))
        assert torch.equal(restored["weight"], want)

    def test_a_failed_save_raises_at_wait(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        mgr = AsyncCheckpointManager(str(tmp_path / "ck"))
        mgr.directory = str(blocker)
        mgr.save(1, tiny_model())
        with pytest.raises(OSError):
            mgr.wait()
