"""The import check: a run that loaded JAX or the JAX package fails; the
port, whose name begins with the JAX package's, passes."""

import sys
import types

from harness.core import import_violations


def test_rejects_jax_and_the_jax_package(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen",
                 "caesar_yolo_tpu", "caesar_yolo_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(import_violations()) >= {"jax", "jax.numpy", "jaxlib",
                                        "flax.linen", "caesar_yolo_tpu",
                                        "caesar_yolo_tpu.models"}


def test_accepts_the_port(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "caesar_yolo_tpu"):
            monkeypatch.delitem(sys.modules, name)
    import caesar_yolo_tpu_torch.cli.run  # noqa: F401
    monkeypatch.setitem(sys.modules, "caesar_yolo_tpu_torchx",
                        types.ModuleType("caesar_yolo_tpu_torchx"))
    assert import_violations() == []
