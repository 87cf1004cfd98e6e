"""Prompt programs for the vision LLM.

Functionally equivalent to the reference's three prompts (ref
pdf_image_segmentation.py:337-613 comprehensive, :826-851 mermaid,
:934-984 calculations): each requests the same JSON response schema the
downstream converters consume. Texts are our own; the response contracts
are the compatibility surface.
"""
from __future__ import annotations

from typing import Optional


def comprehensive_prompt(ocr_text: Optional[str]) -> str:
    ocr_context = ""
    if ocr_text:
        ocr_context = (
            "**OCR text detected in the visual (may contain errors):**\n"
            f"{ocr_text[:1000]}\n\n"
        )
    return f"""You are analyzing one visual element cropped from a textbook page.
{ocr_context}Respond with a single JSON object (no markdown fences) with exactly three top-level keys: "classification", "metadata", "summary".

1. "classification": {{"category": one of "CHART" | "FLOWCHART" | "DIAGRAM" | "IMAGE" | "FIGURE", "confidence": 0.0-1.0}}
   - CHART: numerical axes with plotted data (line, bar, scatter, pie, histogram, candlestick).
   - FLOWCHART: sequential decision flow with boxes/diamonds/arrows.
   - DIAGRAM: labeled nodes and relationships without numeric axes.
   - IMAGE: photograph, screenshot, illustration, scanned page, or embedded table.
   - FIGURE: composite or none-of-the-above (last resort).

2. "metadata": fields depend on the category.
   For CHART: chart_subtype (line|bar|scatter|pie|histogram|candlestick|unknown), x_axis_label, y_axis_label, legend_items (array of strings), value_range ({{"min": number, "max": number}} or null), data_series_count (int), has_grid (bool).
   For FLOWCHART: node_count (int), decision_points (int), has_start_end (bool), flow_direction (top_down|left_right|mixed).
   For DIAGRAM: diagram_subtype (process_flow|decision_tree|hierarchy|cycle|system|network|unknown), node_count (int), has_hierarchy (bool), layout_type (hierarchical_vertical|hierarchical_horizontal|circular|free_form).
   For IMAGE: image_subtype (screenshot|photo|illustration|scanned_page|embedded_table|unknown), contains_text (bool), text_density (none|sparse|moderate|dense), is_embedded_table (bool), plus these arrays (empty array when nothing qualifies):
     - definitions: [{{"term", "definition"}}] — only definitions literally visible in the image.
     - formulas: [{{"formula", "description", "location"}}] — the formula field must be the actual mathematical expression (e.g. "PV = FV / (1 + r)^n"), never just a formula name; you may infer a standard formula from context, marking location as "inferred from domain knowledge".
     - variables: [{{"variable", "meaning"}}] — only when both symbol and meaning are shown.
     - tables: [{{"description", "rows", "columns", "headers", "content_summary"}}] — only for visible table grids; headers exactly as shown or [].
     - input_variables: [{{"variable", "value", "unit"}}] — only values explicitly visible.
     - output_values: [{{"output_name", "value", "location"}}] — only results explicitly visible.
   For FIGURE: is_composite (bool), sub_figure_count (int), contains_chart (bool), contains_diagram (bool), contains_image (bool).
   Never invent variables or values that are not visible; prefer empty arrays over guesses; preserve the exact notation shown.

3. "summary": {{"text": educational summary, "confidence": 0.0-1.0}}.
   Write so a student who cannot see the visual fully understands it. For CHART: type, variables plotted, trends, ranges, notable features. For FLOWCHART/DIAGRAM: purpose, stages/components, flow logic, decision points, outcomes. For IMAGE containing calculations: be exhaustive (8+ sentences) — introduce the subject, list every input variable with value and unit, state every formula with its complete mathematical expression, list every output value with its location, explain how inputs flow through the formulas to the outputs, and end with any remaining context. For FIGURE: content type, main elements, purpose, key takeaway."""


def mermaid_prompt(kind: str, ocr_text: Optional[str]) -> str:
    ocr_context = ""
    if ocr_text:
        ocr_context = f"\n**Text detected in the {kind}:**\n{ocr_text[:500]}\n"
    return f"""Transcribe this {kind} into Mermaid syntax.

Identify every node with its label and every connection with its direction,
then emit ONE fenced code block and nothing else:
- use `flowchart TD`/`flowchart LR` when there are decision nodes,
- `graph TD`/`graph LR` for plain directed structure,
- keep node labels verbatim from the visual,
- preserve the drawing's flow direction.
{ocr_context}
Reply with only the ```mermaid code block."""


def calculations_prompt(ocr_text: Optional[str], nearby_text: Optional[str]) -> str:
    ocr_context = (
        f"\n**OCR text from the image:**\n{ocr_text[:1000]}\n" if ocr_text else ""
    )
    nearby = (
        f"\n**Text near the image on the page:**\n{nearby_text[:500]}\n"
        if nearby_text
        else ""
    )
    return f"""Extract the calculation content of this image.
{ocr_context}{nearby}
Report, as a single JSON object with no prose around it:
- "input_variables": [{{"variable", "value", "unit"}}] — every input parameter whose value is explicitly visible.
- "output_values": [{{"output_name", "value", "location"}}] — every computed result explicitly visible, locating each within the image.
- "formulas": [{{"formula", "description", "location"}}] — formulas visible in the image, or inferred from the input/output relationships and domain (mark location "inferred from domain knowledge"); the formula field must hold the full mathematical expression, never a bare name.
- "verification": {{"verified": bool, "matches": bool, "differences": [strings]}} — recompute the outputs from the inputs and formulas where possible and report whether they agree.

Only report values that are literally visible; empty arrays are correct when nothing qualifies."""


def classify_prompt(ocr_text: Optional[str]) -> str:
    """Stand-alone classification (old-algorithm variant,
    ref pdf_image_segmentation_old_algo.py:295-419)."""
    ocr_context = (
        f"\n**Text detected in the image:**\n{ocr_text[:300]}\n" if ocr_text else ""
    )
    return f"""Classify this textbook visual into exactly one category, preferring the most specific one that fits:

- CHART: quantitative data plotted on numerical axes or as pie slices (line, bar, scatter, histogram, pie, yield curve). Axis scales/tick marks are the tell; a chart captioned "Figure 2.1" is still a CHART.
- FLOWCHART: sequential steps with flowchart shapes — process rectangles, decision diamonds, directed arrows, a start/end.
- DIAGRAM: labeled nodes and connections showing relationships, hierarchy, or system structure, without numeric axes or sequential decision flow.
- IMAGE: photograph, screenshot, illustration, scanned page, or embedded table/graphic; may contain text but no axes or flow structure.
- FIGURE: only for composites mixing several of the above or genuinely unclassifiable visuals.
{ocr_context}
Reply with one JSON object only: {{"category": "CHART|FLOWCHART|DIAGRAM|IMAGE|FIGURE", "confidence": 0.0-1.0, "reasoning": "one sentence"}}"""


_SUMMARY_GUIDES = {
    "chart": "State the chart type, the variables on each axis, every data series, the value ranges, the key trend or comparison the chart makes, and any notable outliers or inflection points.",
    "flowchart": "Walk the flow start to finish: each stage in order, every decision point with its branches, and the possible outcomes.",
    "diagram": "Explain what system or concept the diagram models, each labeled component, how the components connect, and the key relationship it conveys.",
    "image": "Describe what the image shows, any visible text or numbers, its layout, and what a student should take away from it.",
    "figure": "Describe the figure's parts, their arrangement, the purpose of the composite, and its main takeaway.",
    "unknown": "Describe the visible content and its likely educational purpose.",
}


def summary_prompt(visual_type: str, caption: Optional[str],
                   ocr_text: Optional[str]) -> str:
    """Type-aware stand-alone summary (old-algorithm variant,
    ref old_algo :480-594)."""
    guide = _SUMMARY_GUIDES.get(visual_type, _SUMMARY_GUIDES["unknown"])
    ctx = ""
    if caption:
        ctx += f"\nCaption: {caption[:200]}"
    if ocr_text:
        ctx += f"\nDetected text: {ocr_text[:400]}"
    return f"""Write an educational summary (4-7 sentences, plain prose, no markdown) of this {visual_type} for a student who cannot see it. {guide}{ctx}"""
