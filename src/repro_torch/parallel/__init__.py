"""Distribution on the data axis (port of ``parallel/``): the logical-axis
rules (``sharding``), the FSDP weight gather (``reshard``), the stored
shards of the train state (``fsdp``) and the collectives under them
(``collectives``)."""
