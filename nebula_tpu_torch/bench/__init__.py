"""Host-side copies of the reference modules this slice needs."""
