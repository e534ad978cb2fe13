"""Roofline terms of the port's steps: the op counter (``op_cost``), the terms (``analysis``) and the report (``report``)."""
