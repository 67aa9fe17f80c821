"""The benchmark of svgf_tpu_torch on one NVIDIA H100.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line. Everything a
cell needs is found by name: its configuration in configs/<name>.json and
the scene generator it names in scenes/<generator>.py, its traffic mix in
traffic/<name>.json (data) and the kind of traffic that file names in
kinds/<kind>.py (the session, its steps and its output check), each
end-to-end and per-layer metric in e2e/<name>.py and metrics/<name>.py,
each kernel's bound in roofline/<kernel>.py and the limits of the cell's
output check in limits/<cell>.json. reference/ is the plain renderer that
the checks hold the program against; it imports nothing of the program.
"""
