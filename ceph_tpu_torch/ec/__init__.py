"""Erasure codes: interface, device dispatch, plans, the ec_torch codec."""
