"""Distribution of the port, from :mod:`repro.distributed`: gradient
compression (:mod:`.compression`), the logical-axis sharding rules on a
torch ``DeviceMesh`` (:mod:`.sharding`) and the activation policy with
the sharded ops (:mod:`.act_sharding`)."""
