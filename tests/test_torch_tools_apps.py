"""The port's export_model, model_info and dataset apps against the JAX
package's on the same inputs: the same parameter rows and total from
model_info, the same invalid files from dataset, and export_model's
bundle, compiled program and activation dump from a bundle and from the
reference's h5 weights."""

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from facenet_tpu.apps import dataset as jax_dataset_app
from facenet_tpu.apps import model_info as jax_model_info
from facenet_tpu.models import import_weights as jax_iw
from facenet_tpu_torch import export, h5utils
from facenet_tpu_torch.apps import dataset as dataset_app
from facenet_tpu_torch.apps import export_model, model_info
from facenet_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1
from torch_testing import TINY, few_threads, randomized_variables  # noqa: F401


@pytest.fixture(scope='module')
def bundle_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('bundle')
    model = InceptionResnetV1(TINY).from_flax_variables(
        randomized_variables())
    return export.save_model(root / 'tiny', model)


def test_model_info_rows_equal_jax(bundle_dir, capsys):
    result = CliRunner().invoke(jax_model_info.main,
                                ['--path', str(bundle_dir)])
    assert result.exit_code == 0, result.output
    rows = model_info.main(['--path', str(bundle_dir)])
    out = capsys.readouterr().out
    assert out.splitlines() == result.output.splitlines()
    assert 'total parameters: ' in out
    assert len(rows) == sum(1 for line in out.splitlines() if '(' in line)


def test_export_model_from_a_bundle(bundle_dir, tmp_path, capsys):
    out_dir = tmp_path / 'out'
    export_model.main(['--model-dir', str(bundle_dir), '--output',
                       str(out_dir), '--h5', str(tmp_path / 'dump.h5'),
                       '--device', 'cpu'])
    text = capsys.readouterr().out
    assert 'smoke forward: input (1, 160, 160, 3) -> output (1, 32)' in text
    assert (out_dir / 'model.pt2').is_file()
    assert export.load_model(out_dir).model_class == 'InceptionResnetV1'
    names = {d['name'] for d in h5utils.visititems(tmp_path / 'dump.h5')}
    assert sum(n.startswith('activations/') for n in names) == 118
    assert 'input' in names

    hist = model_info.main(['--path', str(out_dir), '--ops', '--device',
                            'cpu'])
    text = capsys.readouterr().out
    assert text.startswith('platforms: cpu') and 'total ops: ' in text
    assert hist['conv2d'] > 10
    model_info.main(['--path', str(out_dir), '--graph', '--device', 'cpu'])
    assert 'aten.conv2d' in capsys.readouterr().out


def test_export_model_imports_reference_h5(tmp_path):
    """--import-h5 of a full-width h5 that JAX's `export_ref_h5` wrote:
    the bundle holds the port's import of it; a TINY h5 mismatches the
    app's default topology and raises, as JAX's app does."""
    from facenet_tpu_torch.models.import_weights import import_h5_weights
    from facenet_tpu_torch.models.inception_resnet_v1 import init_variables

    h5 = jax_iw.export_ref_h5(init_variables(seed=1), tmp_path / 'ref.h5')
    export_model.main(['--import-h5', str(h5), '--output',
                       str(tmp_path / 'out'), '--no-compiled', '--device',
                       'cpu'])
    got = export.load_model(tmp_path / 'out').variables
    want = import_h5_weights(h5)
    np.testing.assert_array_equal(
        got['params']['Bottleneck']['kernel'],
        want['params']['Bottleneck']['kernel'])
    np.testing.assert_array_equal(
        got['batch_stats']['Conv2d_1a_3x3']['bn']['var'],
        want['batch_stats']['Conv2d_1a_3x3']['bn']['var'])
    assert not (tmp_path / 'out' / 'model.pt2').exists()

    with pytest.raises(SystemExit):
        export_model.main(['--output', str(tmp_path / 'x'), '--device',
                           'cpu'])
    tiny = jax_iw.export_ref_h5(randomized_variables(), tmp_path / 't.h5')
    with pytest.raises(ValueError, match='reshape'):
        export_model.main(['--import-h5', str(tiny), '--output',
                           str(tmp_path / 'x'), '--no-compiled',
                           '--device', 'cpu'])


def _dataset(root):
    for c in range(3):
        d = root / f'class_{c}'
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(np.full((8, 8, 3), 40 * c + i, np.uint8)).save(
                d / f'img_{i}.png')
    (root / 'class_0' / 'broken.png').write_bytes(b'not an image at all')
    good = (root / 'class_1' / 'img_0.png').read_bytes()
    (root / 'class_2' / 'truncated.png').write_bytes(good[:20])
    return root


def test_dataset_app_finds_the_same_invalid_files(tmp_path, capsys):
    root = _dataset(tmp_path / 'data')
    result = CliRunner().invoke(jax_dataset_app.main, ['--path', str(root)])
    assert result.exit_code == 0, result.output
    problems = dataset_app.main(['--path', str(root)])
    out = capsys.readouterr().out
    assert 'number of invalid files: 2' in out
    assert 'number of invalid files: 2' in result.output
    bad = sorted(p.split()[1] for p in problems)
    assert bad == sorted(str(root / f) for f in ('class_0/broken.png',
                                                 'class_2/truncated.png'))
