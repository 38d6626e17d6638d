"""The port answers to the JAX package's public names.

For every module of ``torecsys_tpu`` that declares ``__all__`` (but the
Pallas kernels under ``ops/pallas``, whose twins are ``ops.kernels``), each
name resolves in the port's module of the same path, or is one of
:data:`EXCEPTIONS`, each with its reason.  The names keep their meaning:
where two of a JAX module's names are one object (an alias), the port's two
are one object; where a package re-exports a name of one of its
submodules, the port's package re-exports its own submodule's.
"""

import importlib
import pkgutil

import pytest

import torecsys_tpu

# (JAX module, name): why the port has no counterpart
EXCEPTIONS = {
    ("torecsys_tpu.cli", "cli"): "a click group; the port's CLI is argparse (`main`, "
                                 "`make_parser`, `run`) and loads no click",
    ("torecsys_tpu.layers.precision", "use_compute_dtype"):
        "a context read while JAX traces; torch has no trace time, so each module holds its "
        "compute dtype, set by `Pipeline.set_compute_dtype` (`apply_compute_dtype`)",
    ("torecsys_tpu.layers.precision", "compute_dtype"):
        "reads `use_compute_dtype`'s context; the port reads `module.compute_dtype`",
    ("torecsys_tpu.layers.precision", "mha_dtype"):
        "reads `use_compute_dtype`'s context for flax's attention; the port's "
        "`MultiHeadDotProductAttention` holds its `compute_dtype`",
    ("torecsys_tpu.layers.precision", "use_table_dtype"):
        "a context read while JAX traces and initialises; each port table holds its dtype, "
        "set by `Pipeline.set_table_dtype` (`apply_table_dtype`)",
    ("torecsys_tpu.layers.precision", "table_dtype"):
        "reads `use_table_dtype`'s context; the port reads the table's dtype",
}


def _pallas(name: str) -> bool:
    return name.startswith("torecsys_tpu.ops.pallas")


def _modules():
    names = ["torecsys_tpu"] + [info.name for info in pkgutil.walk_packages(
        torecsys_tpu.__path__, prefix="torecsys_tpu.")]
    return sorted(n for n in names if not _pallas(n))


def _port_name(name: str) -> str:
    return "torecsys_tpu_torch" + name[len("torecsys_tpu"):]


@pytest.mark.parametrize("name", _modules())
def test_every_public_name_is_ported_or_excepted(name):
    jax_mod = importlib.import_module(name)
    port = importlib.import_module(_port_name(name))  # every module has its counterpart
    public = getattr(jax_mod, "__all__", None)
    if public is None:
        return
    missing = [n for n in public if not hasattr(port, n) and (name, n) not in EXCEPTIONS]
    assert not missing, f"{_port_name(name)} lacks {missing}"
    stale = [n for n in public if (name, n) in EXCEPTIONS and hasattr(port, n)]
    assert not stale, f"{_port_name(name)} now has the excepted {stale}"
    ported = [n for n in public if (name, n) not in EXCEPTIONS]
    # aliases: one object in the JAX module, one object in the port's
    for i, a in enumerate(ported):
        for b in ported[i + 1:]:
            if getattr(jax_mod, a) is getattr(jax_mod, b):
                assert getattr(port, a) is getattr(port, b), (name, a, b)
    # re-exports: a package's name from its submodule, the port's from its own
    for info in pkgutil.iter_modules(getattr(jax_mod, "__path__", [])):
        sub = getattr(jax_mod, info.name, None)
        if sub is None or _pallas(f"{name}.{info.name}"):
            continue
        port_sub = importlib.import_module(f"{port.__name__}.{info.name}")
        for n in ported:
            if getattr(sub, n, None) is getattr(jax_mod, n) and hasattr(port_sub, n):
                assert getattr(port, n) is getattr(port_sub, n), (name, info.name, n)


def test_exceptions_name_public_names_of_the_jax_package():
    for (name, n), reason in EXCEPTIONS.items():
        assert n in importlib.import_module(name).__all__, (name, n)
        assert reason


def test_precision_dense_is_the_ports_precision_dense():
    from torecsys_tpu_torch.layers import precision
    from torecsys_tpu_torch.layers.ctr.dense import Dense

    assert precision.Dense is Dense
    with pytest.raises(AttributeError):
        precision.no_such_name  # noqa: B018
