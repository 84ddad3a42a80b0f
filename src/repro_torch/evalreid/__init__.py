"""Retrieval evaluation: the numpy oracle and the batched device path."""
