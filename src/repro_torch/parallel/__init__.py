"""The model axis: the reference's partition rules (``sharding``) and
the tensor-parallel collectives the layers call (``hints``)."""
