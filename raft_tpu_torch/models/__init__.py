"""The full RAFT model of the port."""
