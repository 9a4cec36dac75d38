"""Host utilities of the port's CLIs."""
