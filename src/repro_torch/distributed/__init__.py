"""Distribution on ``torch.distributed``: the reference package's sharding
rules as DTensor placements (``sharding``), the tensor-parallel GQA mixer
with K1 on each rank's own heads (``shardmap_attention``) and the
fill-drain pipeline over a stage axis (``pipeline_parallel``)."""
