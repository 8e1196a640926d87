"""Helpers of the port: the training forward's dropout."""
from .random import dropout
