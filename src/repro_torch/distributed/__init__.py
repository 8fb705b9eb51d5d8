"""Distribution and fault tolerance: heartbeats, stragglers, elastic
re-mesh planning (``fault``) and the logical-axis placement rules on a
``DeviceMesh`` (``sharding``)."""
