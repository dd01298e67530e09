"""Experiment drivers — CLI parity with the reference binaries
(reference: src/*.cpp, SURVEY.md section 2.5).

Run as modules:  python -m lane_ans.drivers.table_efficiency -i <dir>
"""
