"""The multi-device solvers of the port: counterpart of c_orb_slam_tpu/parallel/.

``mesh`` is the device mesh and its counted collectives (in process, or
over ``torch.distributed`` ranks); ``dba`` shards a local BA's
observations, ``sharded_ba`` shards the map of a global BA, ``dpose_graph``
shards the essential graph's edges, and ``multihost`` joins the process
group.
"""
