"""Nothing under slambench/reference imports jax, hierslam_tpu, hierslam_torch or
slambench.frozen (which holds copies of the program's helpers)."""
import ast
import os

import pytest

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs if f.endswith(".py"))
FORBIDDEN = {"jax", "hierslam_tpu", "hierslam_torch", "slambench.frozen"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
            if node.module.startswith("slambench.frozen"):
                yield "slambench.frozen"


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, HERE) for p in FILES])
def test_reference_imports_nothing_of_the_program(path):
    assert not FORBIDDEN & set(top_level_imports(path))


