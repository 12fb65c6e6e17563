#!/usr/bin/env python
"""Generate the markdown API reference from the package docstrings.

The reference ships a Doxygen manual (refman.pdf); this is the
equivalent docs build for this framework: one markdown page per
module under ``docs/api/``, regenerated with

    python docs/generate_api.py

(no third-party doc tools required — the environment is hermetic).
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

# Docs build runs against the checkout even when the package is not
# installed (build scripts own their import path).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api")

MODULES = [
    "liblcg_tpu",
    "liblcg_tpu.types",
    "liblcg_tpu.operators",
    "liblcg_tpu.solve",
    "liblcg_tpu.solver_class",
    "liblcg_tpu.solvers.harness",
    "liblcg_tpu.solvers.real",
    "liblcg_tpu.solvers.cplx",
    "liblcg_tpu.solvers.gmres",
    "liblcg_tpu.solvers.minres",
    "liblcg_tpu.solvers.refine",
    "liblcg_tpu.solvers.block",
    "liblcg_tpu.solvers.sstep",
    "liblcg_tpu.solvers.cplx_pairs",
    "liblcg_tpu.solvers.direct",
    "liblcg_tpu.precond.jacobi",
    "liblcg_tpu.precond.incomplete",
    "liblcg_tpu.precond.triangular",
    "liblcg_tpu.precond.blocked_tri",
    "liblcg_tpu.precond.dense",
    "liblcg_tpu.parallel.mesh",
    "liblcg_tpu.parallel.sharded",
    "liblcg_tpu.parallel.stencil",
    "liblcg_tpu.parallel.block_jacobi",
    "liblcg_tpu.parallel.api",
    "liblcg_tpu.ops.spmv",
    "liblcg_tpu.ops.dia",
    "liblcg_tpu.ops.spectra",
    "liblcg_tpu.utils.io",
    "liblcg_tpu.utils.errors",
    "liblcg_tpu.utils.progress",
    "liblcg_tpu.utils.profiling",
    "liblcg_tpu.native",
    "liblcg_tpu.bench",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d or ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]

    members = vars(mod)
    classes = [
        (n, o) for n, o in members.items()
        if inspect.isclass(o) and o.__module__ == modname and _is_public(n)
    ]
    funcs = [
        (n, o) for n, o in members.items()
        if inspect.isfunction(o) and o.__module__ == modname and _is_public(n)
    ]

    for name, cls in classes:
        lines += [f"## class `{name}{_sig(cls)}`", ""]
        if _doc(cls):
            lines += [_doc(cls), ""]
        for mname, meth in vars(cls).items():
            if not _is_public(mname):
                continue
            target = meth.__func__ if isinstance(meth, classmethod) else meth
            if inspect.isfunction(target):
                kind = "classmethod " if isinstance(meth, classmethod) else ""
                lines += [f"### {kind}`{name}.{mname}{_sig(target)}`", ""]
                if _doc(target):
                    lines += [_doc(target), ""]
            elif isinstance(meth, property):
                lines += [f"### property `{name}.{mname}`", ""]
                if _doc(meth):
                    lines += [_doc(meth), ""]

    for name, fn in funcs:
        lines += [f"## `{name}{_sig(fn)}`", ""]
        if _doc(fn):
            lines += [_doc(fn), ""]

    return "\n".join(lines).rstrip() + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# liblcg_tpu API reference", "",
             "Generated by `python docs/generate_api.py`.", ""]
    for modname in MODULES:
        page = modname.replace(".", "_") + ".md"
        text = render_module(modname)
        with open(os.path.join(OUT, page), "w") as f:
            f.write(text)
        first = ""
        mod = importlib.import_module(modname)
        if _doc(mod):
            first = _doc(mod).splitlines()[0]
        index.append(f"- [`{modname}`]({page}) — {first}")
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} pages to {OUT}")


if __name__ == "__main__":
    main()
