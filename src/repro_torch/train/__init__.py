"""The port's training substrate: the reference's AdamW
(``optimizer.py``), the train step every model family returns
(``step.py``: autograd, then that AdamW), the stateless token pipeline
(``data.py``), async checkpoints in the reference's on-disk format
(``checkpoint.py``) and the fault-tolerant loop (``loop.py``)."""
