"""AST-level convention lints (no imports of the linted code): the port of
``repro/analysis/conventions.py``.

Conventions of the port enforced here (every fast path keeps a plain
version and a host oracle, every kernel is held on the card):

  * ``kernel-no-ref`` / ``kernel-ref-unwired`` / ``kernel-no-parity-test``
    / ``kernel-no-smoke`` / ``kernel-module-unwired`` /
    ``kernel-source-unnamed``: a dispatcher is a public function of
    ``src/repro_torch/kernels/ops.py`` that calls ``_on_cuda(`` (the port
    dispatches by the tensors' device, where the reference takes
    ``backend=``). Each needs a ``<name>_ref`` plain version in
    ``kernels/ref.py``, reached through ``REF.<name>_ref`` (in its body,
    or in the module-level op it calls), a ``tests/test_torch_*.py`` that
    names it, and a mention in ``chip_smoke.py``. Every kernel module must
    be imported by ``ops.py`` (``_build.py``, which compiles the sources,
    is exempt) and every ``kernels/csrc/*.cu`` named by a kernel module.
  * ``fast-path-no-oracle`` / ``fast-path-oracle-unresolved``: every
    registered program must name its host oracle, and the dotted path must
    resolve inside ``repro_torch`` (the port imports nothing of the
    reference, so a path outside it is not even imported).
  * ``unused-import``: pyflakes-F401-style unused imports in ``src/`` and
    ``tests/`` (``__init__.py`` re-export modules are exempt).
  * ``dead-module`` / ``seed-module``: modules under
    ``repro_torch.configs`` and ``repro_torch.models`` that no registered
    program reaches through the import graph: ``dead-module`` when no test
    reaches them either (delete), ``seed-module`` when only tests keep
    them alive (they stay only with an allowlist entry in
    ``baseline.json`` stating why).

All functions take the repo root explicitly so the analyzer's own tests
can point them at synthetic known-bad trees.
"""
from __future__ import annotations

import ast
import functools
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.lints import Finding
from repro_torch.analysis.registry import ProgramSpec, resolve_oracle

REPO = "<repo>"    # program slot for repo-level (non-program) findings
PKG = "repro_torch"


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _parse(path: Path) -> Optional[ast.AST]:
    """The file's AST (None if it does not parse), read once per version
    of the file while ``run_convention_lints`` runs: two passes walk every
    source."""
    return _parse_version(str(path), path.stat().st_mtime_ns)


@functools.lru_cache(maxsize=4096)
def _parse_version(path: str, mtime_ns: int) -> Optional[ast.AST]:
    try:
        return ast.parse(Path(path).read_text(), filename=path)
    except SyntaxError:
        return None


# ---------------------------------------------------------------------------
# kernel pairing: module <-> plain version <-> ops dispatcher <-> parity
# test <-> card check
# ---------------------------------------------------------------------------


def _calls(fn: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == name for n in ast.walk(fn))


def _reaches(nodes: Iterable[ast.AST], ref_name: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == ref_name
               and isinstance(n.value, ast.Name) and n.value.id == "REF"
               for node in nodes for n in ast.walk(node))


def lint_kernel_conventions(root: Path) -> List[Finding]:
    kdir = root / "src" / PKG / "kernels"
    tests_dir = root / "tests"
    out: List[Finding] = []
    ops_path, ref_path = kdir / "ops.py", kdir / "ref.py"
    if not ops_path.exists() or not ref_path.exists():
        return [Finding("kernel-no-ref", REPO,
                        f"kernels package at {kdir} lacks ops.py/ref.py")]
    ops_tree = _parse(ops_path)
    ref_tree = _parse(ref_path)
    ref_defs = {n.name for n in ast.walk(ref_tree)
                if isinstance(n, ast.FunctionDef)}
    ref_defs |= {t.id for n in ref_tree.body if isinstance(n, ast.Assign)
                 for t in n.targets if isinstance(t, ast.Name)}
    test_text = "\n".join(p.read_text()
                          for p in sorted(tests_dir.glob("test_torch_*.py")))
    smoke = root / "chip_smoke.py"
    smoke_text = smoke.read_text() if smoke.exists() else ""

    # module-level assignments (the ops a dispatcher may call) and imports
    assigned: Dict[str, ast.AST] = {}
    dispatchers: List[ast.FunctionDef] = []
    for node in ops_tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigned[t.id] = node.value
        elif (isinstance(node, ast.FunctionDef)
              and not node.name.startswith("_")
              and _calls(node, "_on_cuda")):
            dispatchers.append(node)
    ops_imported_modules: Set[str] = set()
    for node in ast.walk(ops_tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            ops_imported_modules.add(node.module)
            ops_imported_modules.update(f"{node.module}.{a.name}"
                                        for a in node.names)

    for fn in dispatchers:
        ref_name = f"{fn.name}_ref"
        called = [assigned[n.id] for n in ast.walk(fn)
                  if isinstance(n, ast.Name) and n.id in assigned]
        if ref_name not in ref_defs:
            out.append(Finding(
                "kernel-no-ref", REPO,
                f"ops dispatcher `{fn.name}` has no `{ref_name}` oracle "
                f"in kernels/ref.py"))
        elif not _reaches([fn, *called], ref_name):
            out.append(Finding(
                "kernel-ref-unwired", REPO,
                f"ops dispatcher `{fn.name}` never routes to "
                f"`REF.{ref_name}` (the CPU path missing)"))
        if not re.search(rf"\b{re.escape(fn.name)}\b", test_text):
            out.append(Finding(
                "kernel-no-parity-test", REPO,
                f"no test under tests/ exercises kernel dispatcher "
                f"`{fn.name}` (ref-vs-kernel parity unguarded)"))
        if not re.search(rf"\b{re.escape(fn.name)}\b", smoke_text):
            out.append(Finding(
                "kernel-no-smoke", REPO,
                f"chip_smoke.py never names kernel dispatcher `{fn.name}` "
                f"(its kernel is not held on the card)"))

    named: Set[str] = set()
    for mod in sorted(kdir.glob("*.py")):
        stem = mod.stem
        if stem in ("__init__", "ops", "ref", "_build"):
            continue
        named |= {n.value for n in ast.walk(_parse(mod))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        if f"{PKG}.kernels.{stem}" not in ops_imported_modules:
            out.append(Finding(
                "kernel-module-unwired", REPO,
                f"kernel module kernels/{stem}.py has no ops.py "
                f"dispatcher entry"))
    for src in sorted((kdir / "csrc").glob("*.cu")):
        if src.stem not in named:
            out.append(Finding(
                "kernel-source-unnamed", REPO,
                f"kernel source kernels/csrc/{src.name} is named by no "
                f"kernel module (never built or launched)"))
    return out


# ---------------------------------------------------------------------------
# fast paths name their host oracle
# ---------------------------------------------------------------------------


def lint_fast_path_oracles(specs: Iterable[ProgramSpec]) -> List[Finding]:
    out: List[Finding] = []
    for spec in specs:
        if not spec.oracle:
            out.append(Finding(
                "fast-path-no-oracle", spec.name,
                "registered fast path declares no host oracle "
                "(oracle=... on register_program)"))
            continue
        if not spec.oracle.startswith(PKG + "."):
            out.append(Finding(
                "fast-path-oracle-unresolved", spec.name,
                f"declared oracle {spec.oracle!r} lies outside {PKG}"))
            continue
        try:
            resolve_oracle(spec.oracle)
        except ImportError:
            out.append(Finding(
                "fast-path-oracle-unresolved", spec.name,
                f"declared oracle {spec.oracle!r} does not resolve"))
    return out


# ---------------------------------------------------------------------------
# unused imports (pyflakes F401, the AST way)
# ---------------------------------------------------------------------------


def _unused_imports_in_file(path: Path) -> List[Finding]:
    tree = _parse(path)
    if tree is None:
        return []
    bound: List = []         # (name, lineno, display)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                bound.append((name, node.lineno, a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                name = a.asname or a.name
                bound.append((name, node.lineno,
                              f"{node.module or '.'}.{a.name}"))
    if not bound:
        return []
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            used.add(node.attr)
    # names re-exported via __all__ count as used
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets)):
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    used.add(c.value)
    return [Finding("unused-import", REPO,
                    f"{path}:{lineno}: `{display}` imported as `{name}` "
                    f"but never used")
            for name, lineno, display in bound if name not in used]


def lint_unused_imports(root: Path,
                        subdirs: Iterable[str] = ("src", "tests")
                        ) -> List[Finding]:
    out: List[Finding] = []
    for sub in subdirs:
        for path in sorted((root / sub).rglob("*.py")):
            if path.name == "__init__.py":      # re-export modules
                continue
            out.extend(_unused_imports_in_file(path))
    return out


# ---------------------------------------------------------------------------
# dead / seed modules under configs/ and models/
# ---------------------------------------------------------------------------


def _module_name(src: Path, path: Path) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _package_imports(tree: ast.AST, modules: Set[str]) -> Set[str]:
    """Module names of the package imported anywhere in the tree."""
    out: Set[str] = set()

    def add(name: str) -> None:
        if name in modules:
            out.add(name)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                add(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            add(node.module)
            for a in node.names:
                add(f"{node.module}.{a.name}")   # from pkg.x import submod
    return out


def build_import_graph(root: Path) -> Dict[str, Set[str]]:
    """module -> set of the package's modules it imports (package inits
    are edges too: importing ``repro_torch.configs`` pulls every config
    module)."""
    src = root / "src"
    files = {p: _module_name(src, p)
             for p in sorted((src / PKG).rglob("*.py"))}
    modules = set(files.values())
    graph: Dict[str, Set[str]] = {m: set() for m in modules}
    for path, mod in files.items():
        tree = _parse(path)
        if tree is None:
            continue
        graph[mod] |= _package_imports(tree, modules)
    return graph


def _reach(graph: Dict[str, Set[str]], roots: Iterable[str]) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(graph.get(m, ()))
        # importing a submodule imports its package __init__ too
        while "." in m:
            m = m.rsplit(".", 1)[0]
            if m in graph and m not in seen:
                seen.add(m)
                stack.extend(graph.get(m, ()))
    return seen


def _strict_graph(graph: Dict[str, Set[str]],
                  scopes: Iterable[str]) -> Dict[str, Set[str]]:
    """The import graph with scope-package ``__init__`` fan-out removed:
    a scope package's init re-exporting every submodule (the registry
    pattern in ``repro_torch.configs``) no longer marks them all
    reachable: a scoped module counts as alive only when some module
    imports it BY NAME. Reachability for tests keeps the full graph (a
    parametrized smoke over the registry is a real consumer); registry
    reachability uses this one, so registry-dead scoped modules surface as
    ``seed-module`` findings that need an explicit allowlist reason."""
    strict = {m: set(es) for m, es in graph.items()}
    for s in scopes:
        if s in strict:
            strict[s] = {e for e in strict[s] if not e.startswith(s + ".")}
    return strict


def lint_dead_modules(root: Path, specs: Iterable[ProgramSpec],
                      scopes: Iterable[str] = (f"{PKG}.configs",
                                               f"{PKG}.models")
                      ) -> List[Finding]:
    graph = build_import_graph(root)
    modules = set(graph)
    test_roots: Set[str] = set()
    for p in sorted((root / "tests").glob("*.py")):
        tree = _parse(p)
        if tree is not None:
            test_roots |= _package_imports(tree, modules)
    registry_roots = {s.module for s in specs if s.module in modules}
    from_registry = _reach(_strict_graph(graph, scopes), registry_roots)
    from_tests = _reach(graph, test_roots)
    out: List[Finding] = []
    for mod in sorted(modules):
        if not any(mod == s or mod.startswith(s + ".") for s in scopes):
            continue
        if mod in from_registry:
            continue
        if mod in from_tests:
            out.append(Finding(
                "seed-module", REPO,
                f"{mod} is reached by tests but by NO registered program "
                f"(seed module: keep only with an allowlist entry)"))
        else:
            out.append(Finding(
                "dead-module", REPO,
                f"{mod} is reached by neither a registered program nor a "
                f"test (delete, or allowlist with a reason)"))
    return out


# ---------------------------------------------------------------------------
# all passes
# ---------------------------------------------------------------------------


def run_convention_lints(root: Path,
                         specs: Iterable[ProgramSpec]) -> List[Finding]:
    specs = list(specs)
    out: List[Finding] = []
    try:
        out += lint_kernel_conventions(root)
        out += lint_fast_path_oracles(specs)
        out += lint_unused_imports(root)
        out += lint_dead_modules(root, specs)
    finally:
        _parse_version.cache_clear()     # the trees are ~80 MB in all
    return out
