"""Multi-process runs: the ``--distributed`` mode over torch.distributed."""
