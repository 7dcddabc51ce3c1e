"""The training losses: one function per objective and the weighted
assembly."""
