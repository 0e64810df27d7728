"""Named configurations of the port."""
