"""Emulated in-network aggregation tier: the fixed-point wire codec
(``fixedpoint``), reduction trees over the data-parallel workers
(``topology``) and the programmable-switch device model (``switch``)."""
