"""The trainer's own StepTimer (``trainer.timer``, host clock around each
step call in ``train_epoch``): host milliseconds to issue a step, mean
over the window's steps. Not the step's time: a queued step reads as
issued."""


def read(run):
    c = run.counters
    return c['issue_s'] * 1e3 if c.get('images') else None
