"""Training-side IO of the port (only the npz variable files so far)."""
