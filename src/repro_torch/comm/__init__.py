"""Communication accounting."""
