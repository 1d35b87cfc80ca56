"""The ctypes declarations of every kernel family (`rrt_tpu_torch.ops.build`)
against the C interfaces their sources export: a declaration with a
parameter too many or too few passes arguments that the kernel reads
wrongly, and shows only on a card, so it is checked here from the
sources."""
import re
import types

import pytest

from rrt_tpu_torch.ops import build

EXPORT = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(rrt_\w+)\s*\(([^)]*)\)')


class _Lib:
    """Stands in for a loaded library: any function, its ctypes fields."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("family", list(build.FAMILIES))
def test_declarations_match_the_c_interface(family):
    fam = build.FAMILIES[family]
    exported = {}
    for src in fam.sources:
        for name, params in EXPORT.findall(src.read_text()):
            params = params.strip()
            exported[name] = (0 if params in ("", "void")
                              else len(params.split(",")))
    lib = _Lib()
    fam.declare(lib)
    declared = {k: len(v.argtypes) for k, v in vars(lib).items()}
    assert declared == exported
