"""Helpers of the port: the training forward's dropout and run names."""
from .names import generate_funny_name
from .random import dropout
