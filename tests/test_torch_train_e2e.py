"""The port's end-to-end training example (`examples/port_train_e2e.py`)
on the CPU: LM_TINY trained 30 steps through `main(argv)` with its own
loss-falls assertion, and the port's `Trainer` against the reference's
`Trainer` (`examples/train_e2e.py`'s LM_TINY and recipe) for 3 steps,
the reference's initial parameters and optimizer state carried into the
port (`repro_torch.convert`); both draw the same `SyntheticLM` numpy
batches.  Bounds: tests/test_torch_train.py's `check_train_step` on
the metrics: loss, lr and grad_norm within 1e-5 relative (float32).
The parameters are not compared: after 3 steps one embedding element of
524,288 sits 9.9e-6 from the reference's, where AdamW divides a
near-zero gradient by its own near-zero second moment: outside
tests/test_torch_train.py's atol 1e-6 + rtol 1e-4."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.train.trainer import Trainer as RefTrainer
from repro_torch import convert
from repro_torch.train.trainer import Trainer
from _torch_parity import one_thread as _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{Path(name).stem}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return _load_example("train_e2e.py"), _load_example("port_train_e2e.py")


def test_port_example_trains_tiny_on_the_cpu(examples, tmp_path, capsys):
    _, port = examples
    out = port.main(["--steps", "30", "--device", "cpu", "--ckpt",
                     str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("model: repro-tiny (")
    assert lines[-1].startswith("loss: ")
    assert len(out["losses"]) == 30
    assert any((tmp_path / "ckpt").iterdir()), "no checkpoint written"


def test_port_configs_are_the_reference_examples(examples):
    ref, port = examples
    for name in ("LM_100M", "LM_TINY"):
        a, b = getattr(ref, name), getattr(port, name)
        assert {f: getattr(a, f) for f in a.__dataclass_fields__} \
            == {f: getattr(b, f) for f in b.__dataclass_fields__}, name


def test_port_trainer_matches_the_reference_trainer(examples):
    ref, port = examples
    steps = 3
    p_tcfg = port.trainer_config(False, 30, None)
    p_tcfg.steps = steps
    r_train = ref.TrainConfig(accum_steps=2, peak_lr=6e-4, warmup=5,
                              total_steps=30, dtype=ref.jnp.float32)
    r_tcfg = ref.TrainerConfig(steps=steps, global_batch=4, seq_len=128,
                               ckpt_dir=None, train=r_train)
    r = RefTrainer(ref.LM_TINY, r_tcfg)
    p = Trainer(port.LM_TINY, p_tcfg, device="cpu")
    p.params = convert.model_params(jax.tree.map(np.asarray, r.params),
                                    port.LM_TINY, device="cpu")
    p.opt = convert.optimizer_state(jax.tree.map(np.asarray, r.opt),
                                    device="cpu")
    r.run()
    p.run()
    for rm, pm in zip(r.metrics, p.metrics, strict=True):
        print(f"step {pm['step']}: loss {pm['loss']:.6f} / {rm['loss']:.6f}"
              f", grad_norm {pm['grad_norm']:.6f} / {rm['grad_norm']:.6f}")
        for key in ("loss", "lr", "grad_norm"):
            assert abs(pm[key] - rm[key]) <= REL * abs(rm[key]), (key, pm,
                                                                   rm)
