"""C5: the port's train apps write the run's log file,
``<logs.dir>/<logs.file>``, as the JAX package's apps do
(`logging.configure_logging(cfg.logs)`); the sink is closed when the run
ends, so later runs do not write into it."""

import logging

import yaml

from facenet_tpu import logging as jax_logging
from facenet_tpu_torch import logging as port_logging
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.utils import synthetic
from torch_testing import few_threads  # noqa: F401


def test_configure_logging_writes_the_file_as_jax(tmp_path):
    for package, name in ((port_logging, 'port'), (jax_logging, 'jax')):
        cfg = Config({'dir': str(tmp_path / name / 'logs'),
                      'file': 'run.log'})
        handler = package.configure_logging(cfg)
        try:
            package.logger.info('a line of the run')
        finally:
            package.logger.removeHandler(handler)
            handler.close()
        text = (tmp_path / name / 'logs' / 'run.log').read_text()
        assert '| INFO    |' in text and 'a line of the run' in text


def test_remove_file_sink_detaches():
    handler = port_logging.add_file_sink('/dev/null')
    port_logging.remove_file_sink(handler)
    assert handler not in port_logging.logger.handlers
    assert all(not isinstance(h, logging.FileHandler)
               for h in port_logging.logger.handlers)


def test_train_detector_app_writes_its_log(tmp_path):
    from facenet_tpu_torch.apps import train_detector

    ann = synthetic.write_detection_dataset(tmp_path / 'scenes', 3,
                                            shape=(96, 96), seed=0,
                                            min_face=30, max_face=60)
    cfg = {'detector': 'mtcnn', 'annotations': str(ann), 'seed': 0,
           'model': {'path': str(tmp_path / 'run')}, 'batch_size': 16,
           'train': {'learning_rate': 0.001,
                     'epoch': {'max_nrof_epochs': 1, 'size': 1}}}
    cfg_file = tmp_path / 'cfg.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    train_detector.main(['--config', str(cfg_file), '--device', 'cpu'])
    (run,) = (tmp_path / 'run').glob('*')
    log = (run / 'logs' / f'{run.name}.log').read_text()
    for net in ('pnet', 'rnet', 'onet'):
        assert f'{net} final:' in log
    assert all(not isinstance(h, logging.FileHandler)
               for h in port_logging.logger.handlers)
