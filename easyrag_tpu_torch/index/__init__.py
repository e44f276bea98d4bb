"""Host-side index structures (numpy)."""
