"""The standalone viewer examples (the port's counterparts of the
repository's ``examples/``), run as modules:

    python -m rspc_tpu_torch.examples.capture OUT_NAME [SOURCE.npz]
    python -m rspc_tpu_torch.examples.cloud_viewer FILE.pcd [YAW] [PITCH]
    python -m rspc_tpu_torch.examples.pcd_visualization FILE.pcd

Each runs on the CUDA card (``main(argv, device="cuda")``); without one
it prints the reason and exits 1.
"""
