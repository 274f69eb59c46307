"""AV1 partition-mode tables and stage label maps (numpy only)."""
