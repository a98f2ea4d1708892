"""Distributed paths over ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU): the process-group helpers (``mesh``), view- and band-sharded
rendering (``render_parallel``), data-parallel and band-sharded GS
training (``gs_data_parallel``, ``gs_band_train``), and the SVD
training steps (``svd_data_parallel``, one card)."""
