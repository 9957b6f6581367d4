"""Port of `mpc_blaster_tpu.models`."""
