"""Distributed paths over ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU): the process-group helpers (``mesh``), view- and band-sharded
rendering (``render_parallel``), data-parallel and band-sharded GS
training (``gs_data_parallel``, ``gs_band_train``), frame-sharded SVD
sampling (``svd_inference_parallel``) and the SVD ControlNet training
steps, on one card and data-parallel (``svd_data_parallel``)."""
