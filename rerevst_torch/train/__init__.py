"""Training — ``rerevst_tpu/train`` for the port: the train state and Adam
(``state``), one step (``step``), the loop (``loop``) and the CLI
(``python -m rerevst_torch.train``)."""
