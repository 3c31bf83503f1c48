"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program."""

import ast
import json
import subprocess
import sys

from .conftest import ROOT

REFERENCE = ROOT / 'benchmark' / 'reference'
PROBE = '''
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark.core import harness, manifest
run = harness.Run(tiny_cell({cell!r}), 3, 0.2, False, device='cpu')
session = manifest.driver(run.traffic).Session(run)
print(json.dumps([harness.forbidden_modules(),
                  'facenet_tpu_torch' in sys.modules]))
'''


def _probe(code):
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cells_set_up_loads_no_jax():
    for cell in ('irv1.embed-b1024', 'irv1.train-b800',
                 'mtcnn-irv1.single-b64'):
        found, port = _probe(PROBE.format(root=str(ROOT),
                                          tests=str(ROOT / 'benchmark' /
                                                    'tests'), cell=cell))
        assert found == [] and port, cell


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split('.')[0])
    return names


def test_the_references_import_nothing_of_the_program():
    for path in REFERENCE.glob('*.py'):
        names = _top_level_imports(path)
        assert not names & {'facenet_tpu_torch', 'facenet_tpu', 'jax',
                            'flax', 'jaxlib'}, path
    code = ('import sys; sys.path.insert(0, {!r}); '
            'import benchmark.reference.irv1, benchmark.reference.mtcnn; '
            'import json; print(json.dumps([sorted(m for m in sys.modules '
            "if m.split('.')[0] in ('facenet_tpu_torch', 'facenet_tpu', "
            "'jax')), 0]))").format(str(ROOT))
    assert _probe(code)[0] == []
