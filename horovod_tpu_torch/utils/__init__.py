"""Environment and logging helpers of the port."""
