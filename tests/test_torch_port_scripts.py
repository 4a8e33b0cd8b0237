"""The port's launch scripts (``bayesian_torch_tpu_torch/scripts``), the
twins of the JAX package's 18 ``scripts/*.sh``: each calls the port's
trainer of the same name with the JAX script's flags and passes ``"$@"``
through, and its flags parse with that trainer's ``build_parser``.
``train_flipout_mnist.sh`` patches the MNIST trainer's ``SCNN`` with the
Flipout SCNN in a heredoc; its patch reaches the model the trainer builds.
No trainer runs here."""

import importlib
import pathlib
import re
import shlex
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SCRIPTS = ROOT / "bayesian_torch_tpu" / "scripts"
PORT_SCRIPTS = ROOT / "bayesian_torch_tpu_torch" / "scripts"
NAMES = sorted(p.name for p in JAX_SCRIPTS.glob("*.sh"))
HEREDOC = "train_flipout_mnist.sh"


def _heredoc(text):
    return text.split("<<'PY'\n", 1)[1].rsplit("PY", 1)[0]


def _call(text, module_re):
    """(trainer module, flag list) of a script's one trainer call."""
    if "<<'PY'" in text:
        body = _heredoc(text)
        module = re.search(r"from (\S+) import main_bayesian_mnist",
                           body).group(1) + ".main_bayesian_mnist"
        flags = re.search(r"m\.main\((\[.*?\])", body).group(1)
        return module, eval(flags)  # a literal list of strings
    (line,) = [ln for ln in text.splitlines() if re.search(module_re, ln)]
    words = shlex.split(line)
    assert words[-1] == "$@", line  # the caller's flags come last
    module = re.search(module_re, line).group(1)
    start = words.index(next(w for w in words if module.split(".")[-1] in w))
    return module, words[start + 1:-1]


def test_every_jax_script_has_a_twin():
    assert len(NAMES) == 18
    assert sorted(p.name for p in PORT_SCRIPTS.glob("*.sh")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_script_flags_parse_with_the_port_trainer(name):
    jax_mod, jax_flags = _call((JAX_SCRIPTS / name).read_text(),
                               r"examples/(\w+)\.py")
    text = (PORT_SCRIPTS / name).read_text()
    mod, flags = _call(text, r"-m (bayesian_torch_tpu_torch\.examples\.\w+)")
    assert text.startswith("#!/bin/bash\n")
    assert flags == jax_flags
    assert mod.rsplit(".", 1)[-1] == jax_mod.rsplit(".", 1)[-1]
    assert mod.startswith("bayesian_torch_tpu_torch.examples.")
    trainer = importlib.import_module(mod)
    args = trainer.build_parser().parse_args(flags)
    assert args.device == "cuda"  # the port's default; "$@" can override
    trainer.build_parser().parse_args(flags + ["--device=cpu"])


def test_flipout_mnist_patch_reaches_the_model(monkeypatch):
    """The heredoc swaps ``main_bayesian_mnist.SCNN`` for the Flipout SCNN
    and calls ``main``: the model ``main`` builds is the Flipout one."""
    from bayesian_torch_tpu_torch.examples import main_bayesian_mnist as m
    from bayesian_torch_tpu_torch.models.flipout.simple_cnn import SCNN

    built = []

    class Stop(Exception):
        pass

    def train(model, *args, **kw):
        built.append(model)
        raise Stop

    monkeypatch.setattr(m, "SCNN", m.SCNN)  # restored after the test
    monkeypatch.setattr(m, "load_mnist", lambda *a: (None, None))
    monkeypatch.setattr(m.engine, "train", train)
    monkeypatch.setattr(sys, "argv", ["-", "--device=cpu"])
    with pytest.raises(Stop):
        exec(_heredoc((PORT_SCRIPTS / HEREDOC).read_text()), {})
    assert type(built[0]) is SCNN
    assert built[0].conv1.estimator == "flipout"
